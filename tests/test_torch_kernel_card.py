"""The CUDA stream-block kernel against its plain PyTorch version, on the card.

Marked ``gpu``: each test skips where there is no CUDA device (the kernel has
no CPU mode). This file imports no JAX, so it runs on a machine with a card
and PyTorch alone:

    python -m pytest tests/test_torch_kernel_card.py -m gpu
"""

import numpy as np
import pytest
import torch

from gaitpd_torch.ops import stream_block as sb
from gaitpd_torch.runtime.device import resolve_device

# (B, T, C_in, K, C_out, t_out, act): the cases of test_torch_stream_block
# plus the serving path's shape (3 streams x 1024 windows, plus a ragged tail)
CASES = [
    (8, 64, 13, 3, 16, 8, "relu"),
    (8, 64, 13, 5, 16, 8, "gelu"),
    (4, 101, 6, 3, 16, 8, "relu"),
    (3, 101, 13, 5, 16, 8, "gelu"),
    (5, 30, 4, 1, 7, 4, "relu"),
    (3, 5, 4, 3, 6, 8, "gelu"),
    (3 * 1024 + 3, 64, 12, 3, 16, 8, "relu"),
]


def _inputs(case, dev, seed=0):
    bsz, t, cin, k, cout, _, _ = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, t, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, w, b)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_on_card(case):
    dev = _cuda()
    x, w, b = _inputs(case, dev)
    before = sb.launches
    got = sb.stream_block(x, w, b, case[5], case[6])
    torch.cuda.synchronize()
    assert sb.launches == before + 1
    want = sb.stream_block_reference(x, w, b, case[5], case[6])
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    dev = _cuda()
    x, w, b = _inputs(CASES[0], dev)
    with pytest.raises(TypeError):
        sb.stream_block(x.double(), w, b)
    with pytest.raises(ValueError):
        sb.stream_block(x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        sb.stream_block(x, w.cpu(), b)
    with pytest.raises(RuntimeError):
        sb.stream_block(x, w.requires_grad_(), b)
