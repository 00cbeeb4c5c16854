"""Per-fold checkpoints and resume. The port's counterpart of
gaitpd/train/checkpoint.py, in its own format: one ``torch.save`` file a
snapshot, read back with ``weights_only=True`` (tensors, dicts, numbers and
strings only).

Layout, as gaitpd's: ``<root>/fold{fi}/latest`` (written every epoch) and
``<root>/fold{fi}/best`` (on improvement), each beside ``latest.json`` or
``best.json`` holding ``epoch`` (0-based), ``best_metric`` and
``no_improve``. A snapshot holds the module's ``state_dict``, the
optimizer's (SGD momentum), the MTL method's state, the fold's numpy
generator state and the step's ``torch.Generator`` state.

gaitpd fast-forwards its key stream on resume by replaying splits. The
port's one generator serves the train and the eval epochs and draws a
number a step that varies with the options, so the port restores the saved
generator state instead. A CPU generator's state is not a CUDA one's: a
run resumed on another kind of device than the one that wrote it raises.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from gaitpd_torch.train.step import TrainState


def fold_path(root, fold: int, which: str) -> Path:
    """``<root>/fold{fold}/{which}``: the snapshot file of ``which``
    ("latest" or "best")."""
    return Path(root) / f"fold{fold}" / which


def save_fold_checkpoint(
    root,
    fold: int,
    state: TrainState,
    *,
    best_metric: float,
    no_improve: int = 0,
    latest: bool = True,
    rng: np.random.Generator,
    generator: torch.Generator,
) -> Path:
    """Write the ``latest`` (or, with ``latest=False``, the ``best``)
    snapshot of a fold and its json beside it; the file is replaced whole,
    so a run cut while writing leaves the previous snapshot."""
    path = fold_path(root, fold, "latest" if latest else "best")
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "module": state.module.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "mtl_state": state.mtl_state,
        "epoch": int(state.epoch),
        "rng": rng.bit_generator.state,
        "generator": generator.get_state(),
        "generator_device": generator.device.type,
    }
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    meta = {"epoch": int(state.epoch), "best_metric": float(best_metric),
            "no_improve": int(no_improve)}
    (path.parent / f"{path.name}.json").write_text(json.dumps(meta))
    return path


def load_snapshot(root, fold: int, which: str = "latest",
                  map_location="cpu") -> Optional[Dict[str, Any]]:
    """The snapshot's payload, its tensors on ``map_location``; None if the
    snapshot or its json is absent."""
    path = fold_path(root, fold, which)
    if not path.exists() or not path.with_name(f"{which}.json").exists():
        return None
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_fold_checkpoint(
    root,
    fold: int,
    state: TrainState,
    *,
    rng: np.random.Generator,
    generator: torch.Generator,
    which: str = "latest",
) -> Optional[Dict[str, Any]]:
    """Load a snapshot into ``state`` (module, optimizer, MTL state, epoch),
    ``rng`` and ``generator`` in place and return its json; None if it is
    absent. Raises ValueError if it was written with a generator on another
    kind of device."""
    payload = load_snapshot(root, fold, which)
    if payload is None:
        return None
    if payload["generator_device"] != generator.device.type:
        raise ValueError(
            f"{fold_path(root, fold, which)} was written by a run on "
            f"{payload['generator_device']!r}, and this run's generator is on "
            f"{generator.device.type!r}: their states differ, so the run cannot resume "
            "the same draws; resume on the device kind that wrote it")
    # load_state_dict copies onto the parameters' device; the generator
    # state stays a CPU tensor, whatever the generator's device
    device = next(state.module.parameters()).device
    state.module.load_state_dict(payload["module"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.mtl_state = {k: v.to(device) for k, v in payload["mtl_state"].items()}
    state.epoch = payload["epoch"]
    rng.bit_generator.state = payload["rng"]
    generator.set_state(payload["generator"])
    return json.loads(fold_path(root, fold, f"{which}.json").read_text())
