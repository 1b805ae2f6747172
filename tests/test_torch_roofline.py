"""The port's roofline (``repro_torch.analysis.roofline``) against the JAX
package's: the analytic parameter and FLOP counts bitwise for all 10
configs (full and smoke widths) and the four shape cells, the three terms
bitwise once the port's rates are set to JAX's, and the port's own rates,
the H100's."""

import pytest

from repro.analysis import roofline as jroof
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config

from repro_torch.analysis import model_flops, roofline, roofline_terms
from repro_torch.configs import SHAPES, get_config, list_archs, smoke_config

CONFIGS = [(a, smoke) for a in list_archs() for smoke in (False, True)]


@pytest.mark.parametrize("arch,smoke", CONFIGS)
def test_param_counts_and_model_flops_equal_jax(arch, smoke):
    cfg = smoke_config(arch) if smoke else get_config(arch)
    jcfg = jax_smoke_config(arch) if smoke else jax_get_config(arch)
    assert roofline.param_counts(cfg) == jroof.param_counts(jcfg)
    for name in SHAPES:
        assert model_flops(cfg, SHAPES[name]) == jroof.model_flops(jcfg, JSHAPES[name]), name


TERMS = [
    dict(flops_per_device=3.7e14, bytes_per_device=2.9e11, collective_operand_bytes=4.1e9,
         n_devices=256, model_flops_global=8.8e16),
    dict(flops_per_device=1.0e9, bytes_per_device=5.0e12, collective_operand_bytes=0.0,
         n_devices=512, model_flops_global=2.0e11),
    dict(flops_per_device=2.0e6, bytes_per_device=1.0e3, collective_operand_bytes=7.0e12,
         n_devices=1, model_flops_global=1.5e6),
    dict(flops_per_device=0.0, bytes_per_device=0.0, collective_operand_bytes=0.0,
         n_devices=256, model_flops_global=0.0),
]


@pytest.mark.parametrize("kw", TERMS)
def test_roofline_terms_equal_jax_at_jax_rates(kw, monkeypatch):
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", jroof.ICI_BW)
    assert roofline_terms(**kw) == jroof.roofline_terms(**kw)


def test_the_ports_rates_are_the_h100s():
    # dense bf16 tensor-core flop/s, HBM3 bytes/s (H100 SXM5 data sheet), and
    # one 400 Gb/s NDR InfiniBand port a card
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9
    assert not hasattr(roofline, "ICI_BW")
    doc = roofline.__doc__
    for rate in ("989e12", "3.35e12", "50e9", "H100", "NDR"):
        assert rate in doc
