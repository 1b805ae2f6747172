"""The dry run's analysis tools (port of ``repro.analysis``): the
three-term roofline over the configs (:mod:`~repro_torch.analysis.roofline`)
and the cost and collective accounting of an eager step
(:mod:`~repro_torch.analysis.op_analysis`, the counterpart of
``hlo_analysis``; :mod:`~repro_torch.analysis.op_top` ranks its ops)."""

from repro_torch.analysis.op_analysis import collective_stats  # noqa: F401
from repro_torch.analysis.roofline import model_flops, roofline_terms  # noqa: F401
