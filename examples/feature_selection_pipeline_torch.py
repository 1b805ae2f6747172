"""mRMR as a first-class data-pipeline stage in front of model training, on
the PyTorch port (the counterpart of
``examples/feature_selection_pipeline.py``).

    PYTHONPATH=src python examples/feature_selection_pipeline_torch.py               # on the card
    PYTHONPATH=src python examples/feature_selection_pipeline_torch.py --device cpu

The paper's motivating workflow: a wide dataset (more features than
observations) is reduced with distributed mRMR, then a downstream model is
trained on the selected columns.  We train the same logistic-regression
head (in PyTorch, the port's AdamW) on (a) all features, (b)
mRMR-selected, (c) randomly selected — showing mRMR keeps accuracy at a
fraction of the width.
"""

import argparse

import numpy as np
import torch

from repro_torch import MRMRSelector, PearsonMIScore
from repro_torch.data.synthetic import continuous_dataset_np
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

N_OBS, N_FEAT, K = 2_000, 8_192, 16


def train_head(Xtr, ytr, Xte, yte, steps=300, lr=0.05):
    gen = torch.Generator(device=Xtr.device).manual_seed(0)
    w = {"w": torch.randn(Xtr.shape[1], generator=gen, device=Xtr.device) * 0.01,
         "b": torch.zeros((), device=Xtr.device)}
    cfg = AdamWConfig(learning_rate=lr, weight_decay=1e-4)
    opt = adamw_init(w, cfg)

    def loss_fn(w, X, y):
        z = X @ w["w"] + w["b"]
        return torch.mean(torch.logaddexp(torch.zeros_like(z), z) - y * z)

    for _ in range(steps):
        w = {k: v.requires_grad_(True) for k, v in w.items()}
        g = dict(zip(w, torch.autograd.grad(loss_fn(w, Xtr, ytr), list(w.values()))))
        w, opt, _ = adamw_update(g, opt, {k: v.detach() for k, v in w.items()}, cfg)
    acc = torch.mean((((Xte @ w["w"] + w["b"]) > 0) == (yte > 0.5)).to(torch.float32))
    return float(acc)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    X, y = continuous_dataset_np(N_OBS, N_FEAT, seed=1)
    y = y.astype(np.float32)
    ntr = int(0.8 * N_OBS)
    Xtr, Xte, ytr, yte = X[:ntr], X[ntr:], y[:ntr], y[ntr:]

    # feature selection sees only the training split (no leakage);
    # Pearson score -> the planner picks the feature-sharded encoding.
    fs = MRMRSelector(num_select=K, score=PearsonMIScore(), device=str(dev)).fit(Xtr, ytr)
    print(f"planned encoding: {fs.plan_.encoding}")
    sel = np.asarray(fs.selected_)
    rng = np.random.default_rng(0)
    rand = rng.choice(N_FEAT, size=K, replace=False)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    acc_all = train_head(on(Xtr), on(ytr), on(Xte), on(yte))
    acc_sel = train_head(on(Xtr[:, sel]), on(ytr), on(Xte[:, sel]), on(yte))
    acc_rnd = train_head(on(Xtr[:, rand]), on(ytr), on(Xte[:, rand]), on(yte))

    print(f"selected (mRMR/Pearson): {sorted(sel.tolist())}")
    print(f"test acc — all {N_FEAT} features: {acc_all:.3f}")
    print(f"test acc — {K} mRMR features:     {acc_sel:.3f}")
    print(f"test acc — {K} random features:   {acc_rnd:.3f}")
    assert acc_sel > acc_rnd + 0.05, "mRMR should beat random selection"


if __name__ == "__main__":
    main()
