"""Epoch index matrices for the on-device batch gather.
The port's own copy of gaitpd/data/sampler.py:144-173.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def batch_index_matrix(
    order: np.ndarray,
    batch_size: int,
    pad_multiple: int = 1,
    quantize_batches: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Chunk a sample order into a padded (n_batches, B) index matrix plus a
    matching validity mask; the partial final batch is padded with index 0
    and valid 0.

    quantize_batches rounds n_batches up to a power of two, as the reference
    does (there it bounds the number of compiled epoch scans); the fully
    padded tail batches change nothing and are dropped from the metrics."""
    n = len(order)
    b = batch_size
    n_batches = max(1, -(-n // b))
    if quantize_batches:
        p = 1
        while p < n_batches:
            p *= 2
        n_batches = p
    total = n_batches * b
    idx = np.zeros(total, dtype=np.int32)
    idx[:n] = order
    valid = np.zeros(total, dtype=np.float32)
    valid[:n] = 1.0
    if pad_multiple > 1 and b % pad_multiple:
        raise ValueError("batch_size must be divisible by the mesh size")
    return idx.reshape(n_batches, b), valid.reshape(n_batches, b)
