"""gaitpd_torch/entry.py on the CPU: ``entry()``'s forward returns the
(64, 2) masked-ensemble probabilities, as tests/test_e2e.py::
test_graft_entry_contract holds gaitpd's; ``dryrun_multichip`` without a
card and without device="cpu" raises before it spawns a rank; a rank that
raises fails ``run_ranks`` with its traceback, every rank stopped (a
timeout of its own). The dry run's five phases at n = 4 on the CPU take
about 35 s: README.md says how to run them.
"""

import pytest
import torch

from gaitpd_torch import entry as E


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_contract():
    fn, args = E.entry(device="cpu")
    out = fn(*args)
    assert tuple(out.shape) == (64, 2)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.sum(-1), torch.ones(64), rtol=0, atol=1e-6)
    model, xw, xi, xm, mask = args
    alone = fn(model, xw, xi, xm, torch.tensor([True, False, False]))
    want = torch.softmax(model(xw, torch.zeros_like(xi), torch.zeros_like(xm))[0], -1)
    torch.testing.assert_close(alone, want, rtol=0, atol=1e-6)


def test_dryrun_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the dry run would run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.dryrun_multichip(2)


def _fails_on_rank_1(rank, n):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def test_a_failing_rank_fails_run_ranks():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank 1 fails"):
        E.run_ranks(_fails_on_rank_1, 2, timeout=120.0)
