#!/usr/bin/env python3
"""How far f32 rounding-level differences grow in one epoch of the port's
WearGait CAGrad training, on the CPU alone.

    python scripts/torch_train_sensitivity.py [--eps 1e-7] [--seed 0]

Trains gaitpd_torch's run_cv for one epoch twice with the plain versions
(device "cpu"), with the configuration of chip_smoke.py's training phase:
once from the seeded initial parameters, once from the same parameters
scaled by 1 + eps * N(0, 1). Prints both runs' epoch losses and the largest
parameter gap after the epoch. chip_smoke.py's card-vs-CPU tolerance for the
parameters after one epoch is set against this gap: a gap of that size
needs no difference between the two runs but the rounding of their sums.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gaitpd_torch.train import weargait_driver as wg  # noqa: E402


def train_one_epoch(seed: int, eps: float):
    """(epoch-1 losses, parameters after epoch 1) of a run whose initial
    parameters are scaled by 1 + eps * N(0, 1) (a fixed noise draw)."""
    orig_init = wg.init_train_state
    result = {}

    def init(model, *a, **k):
        with torch.no_grad():
            g = torch.Generator().manual_seed(123)
            for p in model.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=g))
        return orig_init(model, *a, **k)

    def hook(fold, epoch, state, tr, ev):
        result["loss"] = tr.loss.tolist()
        result["params"] = {n: p.detach().clone() for n, p in state.module.named_parameters()}

    args = wg.WearGaitArgs(synthetic=True, seed=seed, n_folds_cap=1, batch_size=64,
                               wm="gcl", alpha=0.5, verbose=False, epochs=1, device="cpu")
    wg.init_train_state = init
    try:
        wg.run_cv(args, on_epoch=hook)
    finally:
        wg.init_train_state = orig_init
    return result["loss"], result["params"]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--eps", type=float, default=1e-7)
    parser.add_argument("--seed", type=int, default=0)
    ns = parser.parse_args()
    loss0, p0 = train_one_epoch(ns.seed, 0.0)
    loss1, p1 = train_one_epoch(ns.seed, ns.eps)
    gap = max((p0[n] - p1[n]).abs().max().item() for n in p0)
    print(json.dumps({"eps": ns.eps, "epoch1_loss": loss0, "epoch1_loss_perturbed": loss1,
                      "max_param_gap_after_epoch1": gap,
                      "max_abs_param": max(p.abs().max().item() for p in p0.values())}))


if __name__ == "__main__":
    main()
