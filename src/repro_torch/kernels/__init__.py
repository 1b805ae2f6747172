"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the dispatcher between them (:mod:`repro_torch.kernels.ops`)."""
