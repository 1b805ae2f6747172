"""The LM side of the port: dense decoders served through the
flash-attention kernel (:mod:`repro_torch.models.model`)."""

from repro_torch.models.model import DecoderLM, build_model  # noqa: F401
