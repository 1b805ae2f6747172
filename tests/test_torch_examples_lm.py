"""The PyTorch port's LM examples, ``examples/serve_lm_torch.py`` and
``examples/train_lm_torch.py``, run as scripts with ``--device cpu`` and
``jax`` / ``repro`` unimportable (``test_torch_examples.py``'s runner):
exit 0 and their printed checks."""

import json
import re

from test_torch_examples import _ok, _run


def test_serve_lm():
    out = _ok(_run("serve_lm", "--device", "cpu"))
    reqs = re.findall(r"req \d: prompt_len=\s*(\d+) -> (\[.*\])", out)
    assert [int(n) for n, _ in reqs] == [8, 8, 8, 16, 16, 24, 24, 24]
    assert all(len(json.loads(toks)) == 12 for _, toks in reqs)
    assert "8 requests / 96 new tokens" in out


def test_train_lm_restarts_after_its_injected_crash(tmp_path):
    """One step of the ~100M model with the crash injected before it: the
    restart loop re-initialises (no checkpoint yet) and completes."""
    out = _ok(_run("train_lm", "--steps", "1", "--fail-at-step", "0", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path), timeout=600))
    final = json.loads(out.strip().splitlines()[-2])  # the train command line's JSON line
    assert final["device"] == "cpu" and final["steps"] == 1 and final["restarts"] == 1
    assert 100e6 < final["params"] < 140e6
    assert final["last_ckpt"] == 1 and len(final["losses"]) == 1
    assert out.strip().splitlines()[-1].startswith("final: {")
