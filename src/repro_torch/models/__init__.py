"""The LM side of the port: every family of the registry served through the
flash-attention kernel (:mod:`repro_torch.models.model`,
:mod:`repro_torch.models.encdec`)."""

from repro_torch.models.encdec import EncDecLM  # noqa: F401
from repro_torch.models.model import DecoderLM, build_model  # noqa: F401
