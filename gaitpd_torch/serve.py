"""Batch and streaming inference: raw sensor streams -> PD predictions.
Port of gaitpd/serve.py:32-263.

The engine runs z-score -> window -> WearGaitThreeModal forward -> masked
softmax ensemble on one device: the card by default, the CPU when the caller
passes ``device="cpu"``. Any subset of sensors may be present (relaxed
input): absent streams are zero-filled and their heads left out of the
ensemble.

    engine = WearGaitEngine(module_or_flax_params, stats, win=64, hop=64)
    engine = WearGaitEngine.from_checkpoint("ck", fold=1)  # the port's training
    probs = engine.predict_streams({"imu": imu_array})   # walkway/insole absent

``from_checkpoint`` reads the port's own checkpoints
(gaitpd_torch.train.checkpoint), ``from_vmap_checkpoint`` one fold of the
stacked snapshot that the vmapped CV writes (gaitpd_torch.train.vmap_cv).
Restoring gaitpd's orbax checkpoints needs orbax and tensorstore and is not
ported: pass the restored flax variables dict to the engine.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gaitpd_torch.data.pipeline import window_stream, zscore
from gaitpd_torch.models.multitask import CHANNELS, MODALITIES, WearGaitThreeModal
from gaitpd_torch.params import load_flax_params
from gaitpd_torch.runtime.device import DeviceLike, resolve_device
from gaitpd_torch.train.checkpoint import fold_path, load_snapshot


class WearGaitEngine:
    """Relaxed-input WearGait classifier over raw 30 Hz streams.

    ``params_or_module`` is either a port module (copied, so the caller's
    module stays where it is) or a flax variables dict, which is copied into
    ``model`` (default: a synchronized ``WearGaitThreeModal``)."""

    def __init__(
        self,
        params_or_module,
        stats: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
        *,
        win: int = 64,
        hop: int = 64,
        model: Optional[WearGaitThreeModal] = None,
        num_classes: int = 2,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if isinstance(params_or_module, nn.Module):
            module = copy.deepcopy(params_or_module)
        else:
            module = load_flax_params(
                copy.deepcopy(model) if model is not None
                else WearGaitThreeModal(synchronized=True, num_classes=num_classes),
                params_or_module,
            )
        self.model = module.to(self.device).eval()
        self.win = win
        self.hop = hop
        self.stats = {}  # host copies: StreamingSession z-scores on the host
        self._dev_stats = {}
        for m in MODALITIES:
            if stats and m in stats:
                mean, std = stats[m]
            else:
                mean = np.zeros(CHANNELS[m], np.float32)
                std = np.ones(CHANNELS[m], np.float32)
            mean = np.asarray(mean, np.float32)
            std = np.asarray(std, np.float32)
            self.stats[m] = (mean, std)
            self._dev_stats[m] = (torch.as_tensor(mean, device=self.device),
                                  torch.as_tensor(std, device=self.device))

    @classmethod
    def from_checkpoint(cls, ckpt_root, fold: int = 1, which: str = "best", *,
                        model: Optional[nn.Module] = None, num_classes: int = 2, **kw):
        """An engine on the fold's ``which`` ("best" or "latest") parameters
        saved by the port's training (``ckpt_dir``), copied into ``model``
        (default: a synchronized ``WearGaitThreeModal``), with the z-score
        stats of ``<ckpt_root>/stats.json`` where that exists
        (gaitpd/serve.py:81-90)."""
        payload = load_snapshot(ckpt_root, fold, which)
        if payload is None:
            raise FileNotFoundError(f"no checkpoint at {fold_path(ckpt_root, fold, which)}")
        module = copy.deepcopy(model) if model is not None else WearGaitThreeModal(
            synchronized=True, num_classes=num_classes)
        module.load_state_dict(payload["module"])
        return cls(module, cls._load_stats(ckpt_root), **kw)

    @classmethod
    def from_vmap_checkpoint(cls, ckpt_root, fold: int = 0, *,
                             model: Optional[nn.Module] = None, num_classes: int = 2, **kw):
        """An engine on one fold's best parameters out of the stacked
        snapshot that the vmapped CV driver writes (``<ckpt_root>/vmap/
        latest``, gaitpd_torch.train.vmap_cv.save_vmap_checkpoint; the
        flagship keeps every fold's best parameters in
        ``extras["best_params"]``, the fold on the leading axis), copied into
        ``model`` (default: a synchronized ``WearGaitThreeModal``), with the
        stats of ``<ckpt_root>/stats.json`` where that exists
        (gaitpd/serve.py:91-117). ``fold`` is 0-based. Raises ValueError on a
        snapshot without best parameters (the single-modality driver saves
        none) or a fold out of range."""
        from gaitpd_torch.train.vmap_cv import load_vmap_snapshot, vmap_checkpoint_path

        payload = load_vmap_snapshot(ckpt_root)
        path = vmap_checkpoint_path(ckpt_root)
        if payload is None:
            raise FileNotFoundError(f"no stacked checkpoint at {path}")
        extras = payload.get("extras") or {}
        if "best_params" not in extras:
            raise ValueError(
                f"{path} is not a WearGait flagship's vmapped snapshot: its extras carry no "
                "'best_params' (the single-modality driver saves none); serve from a "
                "weargait --vmap_folds checkpoint")
        best = extras["best_params"]
        n_folds = next(iter(best.values())).shape[0]
        if not 0 <= fold < n_folds:
            raise ValueError(f"fold {fold} out of range (snapshot has {n_folds} folds, "
                             "0-based)")
        module = copy.deepcopy(model) if model is not None else WearGaitThreeModal(
            synchronized=True, num_classes=num_classes)
        module.load_state_dict({name: v[fold] for name, v in best.items()})
        return cls(module, cls._load_stats(ckpt_root), **kw)

    @staticmethod
    def _load_stats(ckpt_root):
        """Per-modality (mean, std) from <ckpt_root>/stats.json, None if absent."""
        stats_path = Path(ckpt_root) / "stats.json"
        if not stats_path.exists():
            return None
        raw = json.loads(stats_path.read_text())
        return {
            m: (np.asarray(v[0], np.float32), np.asarray(v[1], np.float32))
            for m, v in raw.items()
        }

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def _predict(self, xs, mask: Sequence[bool]) -> torch.Tensor:
        """Mean of the softmax of the enabled heads. The reference multiplies
        every head by its 0/1 mask and sums; leaving the disabled heads out of
        the sum gives the same floats, with no mask on the device."""
        logits = self.model(*xs)
        probs = [torch.softmax(lg, -1) for lg, on in zip(logits, mask) if on]
        return torch.stack(probs).sum(0) / float(max(len(probs), 1))

    # ------------------------------------------------------------------
    def predict_windows(self, windows: Dict[str, np.ndarray]) -> np.ndarray:
        """windows: modality -> (N, win, C) pre-windowed batches (numpy arrays
        or tensors); absent modalities are masked out. Returns
        (N, num_classes) probabilities."""
        present = [m for m in MODALITIES if m in windows]
        if not present:
            raise ValueError("at least one modality required")
        n = windows[present[0]].shape[0]
        xs, mask = [], []
        for m in MODALITIES:
            if m in windows:
                xs.append(self._tensor(windows[m]))
                mask.append(True)
            else:
                xs.append(torch.zeros((n, self.win, CHANNELS[m]), dtype=torch.float32,
                                      device=self.device))
                mask.append(False)
        return self._predict(xs, mask).cpu().numpy()

    def predict_streams(self, streams: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """streams: modality -> (T, C) raw 30 Hz stream (any subset).
        Windows each stream, classifies per window, and aggregates to a
        subject-level probability (mean over windows).
        Returns {"window_probs": (N, C), "subject_probs": (C,), "pred": int}.
        """
        windows = {}
        for m, x in streams.items():
            if m not in CHANNELS:
                raise ValueError(f"unknown modality {m}")
            mean, std = self._dev_stats[m]
            windows[m] = window_stream(zscore(self._tensor(x), mean, std),
                                       self.win, self.hop)
        n = min(w.shape[0] for w in windows.values())
        if n == 0:
            raise ValueError(f"streams shorter than one window ({self.win})")
        probs = self.predict_windows({m: w[:n] for m, w in windows.items()})
        subject = probs.mean(axis=0)
        return {
            "window_probs": probs,
            "subject_probs": subject,
            "pred": int(subject.argmax()),
        }


class StreamingSession:
    """Real-time serving session: push sensor frames as they arrive; windows
    are cut by the native C++ ring buffers (gaitpd_torch.native) and
    classified in batches by the engine. One buffer per modality; modalities
    may stream at their own pace and any subset may be absent."""

    def __init__(self, engine: WearGaitEngine, modalities: Sequence[str] = MODALITIES):
        from gaitpd_torch.native import StreamWindowBuffer

        self.engine = engine
        self.buffers = {
            m: StreamWindowBuffer(CHANNELS[m], engine.win, engine.hop)
            for m in modalities
        }

    def push(self, modality: str, frames: np.ndarray) -> None:
        mean, std = self.engine.stats[modality]
        z = np.asarray(
            (np.nan_to_num(frames, nan=float("nan")) - mean) / std, np.float32,
        )
        z = np.nan_to_num(z, nan=0.0, posinf=0.0, neginf=0.0)
        self.buffers[modality].push(z)

    def poll(self) -> Optional[Dict[str, np.ndarray]]:
        """Classify all complete windows available across the streaming
        modalities (aligned to the slowest one). None if nothing ready."""
        n = self.n_ready()
        if n == 0:
            return None
        probs = self.engine.predict_windows(self.pop_windows(n))
        return {"window_probs": probs, "pred": probs.argmax(1)}

    def n_ready(self) -> int:
        """Complete windows available across all modalities (min over the
        per-modality ring buffers: aligned to the slowest stream)."""
        ready = [b.ready for b in self.buffers.values()]
        return min(ready) if ready else 0

    def pop_windows(self, n: int) -> Dict[str, np.ndarray]:
        """Pop n aligned windows per modality out of the ring buffers."""
        return {m: self.buffers[m].pop(n) for m in self.buffers}


def poll_sessions(sessions: Sequence[StreamingSession]) -> list:
    """Throughput-mode serving: drain the ready windows of many concurrent
    sessions and classify them in one batched predict per group, instead of
    one call per session. Sessions are grouped by engine (each batch is
    scored by its own parameters) and by modality subset (each group has one
    mask).

    Returns a list aligned with `sessions`: {"window_probs", "pred"} for
    sessions that had complete windows, None for the rest."""
    results: list = [None] * len(sessions)
    groups: Dict[tuple, list] = {}
    for idx, s in enumerate(sessions):
        n = s.n_ready()
        if n == 0:
            continue
        key = (id(s.engine), tuple(sorted(s.buffers)))
        groups.setdefault(key, []).append((idx, n, s.pop_windows(n)))
    for (_, mods), members in groups.items():
        batch = {
            m: np.concatenate([w[m] for _, _, w in members], axis=0)
            for m in mods
        }
        engine = sessions[members[0][0]].engine
        probs = engine.predict_windows(batch)
        off = 0
        for idx, n, _ in members:
            p = probs[off:off + n]
            off += n
            results[idx] = {"window_probs": p, "pred": p.argmax(1)}
    return results
