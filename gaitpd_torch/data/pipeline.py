"""Preprocessing on tensors: pose normalisation, z-score and strict
sliding windows.

Port of gaitpd/data/pipeline.py (the device half, :73-157, plus its own
copies of the numpy helpers :29-65). Every transform is a batched function
on a tensor, so it runs wherever the stream lies: on the card in serving,
on the CPU in the tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

MIN_STD_POSE = 1e-4  # reference dataloader_fbg_fog.py:20
MIN_STD_WG = 1e-6  # reference dataloader_weargait.py:28


# ---------------------------------------------------------------------------
# Host-side helpers (ragged raw sequences -> fixed arrays)
# ---------------------------------------------------------------------------


def pad_or_trim(seq: np.ndarray, target_len: int, pad_value: float = 0.0) -> np.ndarray:
    """End-pad or head-trim a (T, ...) sequence to exactly target_len frames."""
    length = seq.shape[0]
    if length == target_len:
        return seq
    if length > target_len:
        return seq[:target_len]
    pad = np.full((target_len - length, *seq.shape[1:]), pad_value, dtype=seq.dtype)
    return np.concatenate([seq, pad], axis=0)


def window_indices(n_frames: int, win: int, hop: int):
    """Strict full windows: [(wid, start, end)]."""
    out = []
    if n_frames <= 0 or n_frames < win:
        return out
    start, wid = 0, 0
    while start + win <= n_frames:
        out.append((wid, start, start + win))
        start += hop
        wid += 1
    return out


def window_stream_np(x: np.ndarray, win: int, hop: int) -> np.ndarray:
    """(T, C) -> (n_win, win, C) strict full windows, as a contiguous copy."""
    t = x.shape[0]
    n = 0 if t < win else (t - win) // hop + 1
    if n == 0:
        return np.zeros((0, win) + x.shape[1:], dtype=x.dtype)
    s0, s1 = x.strides[0], x.strides[1:]
    view = np.lib.stride_tricks.as_strided(
        x, shape=(n, win) + x.shape[1:], strides=(hop * s0, s0) + s1, writeable=False
    )
    return np.ascontiguousarray(view)


# ---------------------------------------------------------------------------
# Batched transforms on tensors
# ---------------------------------------------------------------------------


def center_poses(poses: torch.Tensor, root: int = 0) -> torch.Tensor:
    """(N, T, J, 3) minus the root joint a frame (reference
    dataloader_fbg_fog.py:93-99)."""
    return poses - poses[:, :, root : root + 1, :]


def minmax_poses(poses: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-sample min-max over (T, J) into [0, 1] a coordinate (reference
    dataloader_fbg_fog.py:107-113)."""
    mins = poses.amin(dim=(1, 2), keepdim=True)
    maxs = poses.amax(dim=(1, 2), keepdim=True)
    return (poses - mins) / (maxs - mins + eps)


def zscore_poses(poses: torch.Tensor, mean, std, min_std: float = MIN_STD_POSE):
    """Global z-score, a std below ``min_std`` taken as 1 (reference
    dataloader_fbg_fog.py:114-119)."""
    std = torch.as_tensor(std, dtype=poses.dtype, device=poses.device)
    std = torch.where(std < min_std, torch.ones_like(std), std)
    return (poses - torch.as_tensor(mean, dtype=poses.dtype, device=poses.device)) / std


def zscore(
    x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, min_std: float = MIN_STD_WG
) -> torch.Tensor:
    """Per-channel z-score with the reference's NaN guards: non-finite inputs
    take the mean before the transform, std is floored at ``min_std`` (a
    non-finite std too), and residual non-finites become 0."""
    mean = torch.where(torch.isfinite(mean), mean, torch.zeros_like(mean))
    std = torch.where(
        torch.isfinite(std) & (std > min_std), std, torch.full_like(std, min_std)
    )
    x = torch.where(torch.isfinite(x), x, mean)
    z = (x - mean) / std
    return torch.where(torch.isfinite(z), z, torch.zeros_like(z))


def fit_zscore_stats(x: torch.Tensor, axis=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """NaN-aware per-channel mean and std over the leading ``axis`` (an int
    or a tuple of the leading axes, e.g. (0, 1) for (N, T, C))."""
    finite = torch.isfinite(x)
    xf = torch.where(finite, x, torch.zeros_like(x))
    n = torch.clamp(finite.sum(dim=axis), min=1).to(x.dtype)
    mean = xf.sum(dim=axis) / n
    dev = torch.where(finite, (x - mean) ** 2, torch.zeros_like(x))
    var = dev.sum(dim=axis) / n
    std = torch.clamp(torch.sqrt(torch.clamp(var, min=0.0)), min=MIN_STD_WG)
    return mean, std


def window_stream(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """(T, C) -> (n_win, win, C) strict full windows.

    Three paths, as in the reference: hop == win is a reshape (a view);
    win % hop == 0 interleaves win//hop phase-shifted reshapes; any other hop
    gathers."""
    t = x.shape[0]
    n = 0 if t < win else (t - win) // hop + 1
    if n <= 0:
        return x.new_zeros((0, win) + tuple(x.shape[1:]))
    if hop == win:
        return x[: n * win].reshape((n, win) + tuple(x.shape[1:]))
    if win % hop == 0:
        # windows starting at phase j*hop come from the reshape of x[j*hop:]
        outs = []
        for j in range(win // hop):
            xo = x[j * hop :]
            nj = xo.shape[0] // win
            outs.append(xo[: nj * win].reshape((nj, win) + tuple(x.shape[1:])))
        max_nj = max(o.shape[0] for o in outs)
        padded = [
            F.pad(o, (0, 0) * (o.dim() - 1) + (0, max_nj - o.shape[0])) for o in outs
        ]
        inter = torch.stack(padded, dim=1).reshape((-1, win) + tuple(x.shape[1:]))
        return inter[:n]
    starts = torch.arange(n, device=x.device) * hop
    idx = starts[:, None] + torch.arange(win, device=x.device)[None, :]
    return x[idx]
