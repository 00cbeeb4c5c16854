"""Simplex solvers of the multitask weighting, in plain PyTorch.
Port of gaitpd/learning/minnorm.py:19-158: ``project_simplex``,
``cagrad_weights``, ``min_norm_element`` (MGDA), ``fairgrad_weights`` and
``nashmtl_weights``.

Each solver takes a batch of problems along the leading axis as well as a
single one: the loops are fixed and elementwise across problems, so one
call solves many at the cost of one. On the training path the weights come
from the CUDA kernels of gaitpd_torch/ops/cagrad_solver.py and
gaitpd_torch/ops/mtl_solvers.py; the functions here are their plain
versions (CPU tensors, and the comparison on the card). Their sums are
written out term by term, in the kernels' order, and every step is one IEEE
operation, so kernel and plain version agree bit for bit; against gaitpd
they agree to the rounding of the sums (see tests/test_torch_minnorm.py and
tests/test_torch_mtl_methods.py). The K x K Newton systems of FairGrad and
NashMTL are solved by Gaussian elimination without pivoting, written out:
their matrices are G + diag(positive) + EPS·I, symmetric positive definite
for a PSD Gram matrix, and ``torch.linalg.solve`` would check its result on
the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

EPS = 1e-8
INVPHI = 0.6180339887498949


def _cumsum(u: torch.Tensor) -> torch.Tensor:
    """Running sum along the last axis, added left to right."""
    out = [u[..., 0]]
    for j in range(1, u.shape[-1]):
        out.append(out[-1] + u[..., j])
    return torch.stack(out, dim=-1)


def project_simplex(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of v (..., K) onto the probability simplex
    (sort-based algorithm)."""
    k = v.shape[-1]
    u = torch.sort(v, dim=-1, descending=True).values
    css = _cumsum(u) - 1.0
    ind = torch.arange(1, k + 1, dtype=v.dtype, device=v.device)
    cond = u - css / ind > 0
    idx = torch.arange(k, device=v.device).expand_as(u)
    rho = torch.where(cond, idx, torch.zeros_like(idx)).amax(dim=-1, keepdim=True)
    theta = css.gather(-1, rho) / (rho.to(v.dtype) + 1.0)
    return torch.clamp(v - theta, min=0.0)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of (N, K) tensors -> (N,), added left to right."""
    s = a[:, 0] * b[:, 0]
    for j in range(1, a.shape[-1]):
        s = s + a[:, j] * b[:, j]
    return s


def _matvec(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, K, K) @ (N, K) -> (N, K), each row added left to right."""
    s = g[:, :, 0] * w[:, None, 0]
    for j in range(1, w.shape[-1]):
        s = s + g[:, :, j] * w[:, None, j]
    return s


def sum_entries(g: torch.Tensor, square: bool = False) -> torch.Tensor:
    """Sum of the entries (or of their squares) of each (K, K) matrix of
    g (N, K, K) -> (N,), added in row-major order."""
    flat = g.reshape(g.shape[0], -1)
    s = flat[:, 0] * flat[:, 0] if square else flat[:, 0]
    for j in range(1, flat.shape[-1]):
        s = s + (flat[:, j] * flat[:, j] if square else flat[:, j])
    return s


def cagrad_weights(gram: torch.Tensor, c_coef: Union[torch.Tensor, float],
                   iters: int = 60, ls_iters: int = 30) -> torch.Tensor:
    """Solve the CAGrad dual  min_{w in simplex}  wᵀ G w̄ + c √(wᵀ G w)
    with w̄ = 1/K (reference multitask_weighting.py:694-718): projected
    gradient with a golden-section line search along each projected
    direction, then a polish along the pairwise directions e_i - e_j, with
    the reference's fixed iteration counts.

    gram: (K, K) or (N, K, K); c_coef: a scalar or (N,). Returns (K,) or
    (N, K)."""
    single = gram.dim() == 2
    g = gram.unsqueeze(0) if single else gram
    n, k, _ = g.shape
    c = torch.as_tensor(c_coef, dtype=g.dtype, device=g.device).reshape(-1)
    c = (c.expand(n) if c.numel() == 1 else c.reshape(n)).unsqueeze(-1)  # (N, 1)

    b = torch.full((n, k), 1.0 / k, dtype=g.dtype, device=g.device)
    gb = _matvec(g, b)
    lips = (torch.sqrt(sum_entries(g, square=True)).unsqueeze(-1) + c) + EPS

    def f(w):  # (N, K) -> (N, 1)
        root = torch.sqrt(_dot(w, _matvec(g, w)) + EPS).unsqueeze(-1)
        return _dot(w, gb).unsqueeze(-1) + c * root

    def golden(w, d):
        lo = torch.zeros((n, 1), dtype=g.dtype, device=g.device)
        hi = torch.ones((n, 1), dtype=g.dtype, device=g.device)
        for _ in range(ls_iters):
            m1 = hi - INVPHI * (hi - lo)
            m2 = lo + INVPHI * (hi - lo)
            go_right = f(w + m1 * d) > f(w + m2 * d)
            lo, hi = torch.where(go_right, m1, lo), torch.where(go_right, hi, m2)
        return 0.5 * (lo + hi)

    def line_step(w, d):
        w_new = w + golden(w, d) * d
        return torch.where(f(w_new) < f(w), w_new, w)

    w = b
    for _ in range(iters):
        gw = _matvec(g, w)
        root = torch.sqrt(_dot(w, gw) + EPS).unsqueeze(-1)
        grad = gb + c * gw / root
        w = line_step(w, project_simplex(w - grad / lips) - w)

    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    for _ in range(4):
        for i in range(k):
            for j in range(k):
                if i != j:
                    w = line_step(w, (eye[i] - eye[j]) * w[:, j : j + 1])
    return w[0] if single else w


def _batched(gram: torch.Tensor):
    """(K, K) or (N, K, K) -> ((N, K, K), whether it was a single matrix)."""
    single = gram.dim() == 2
    return (gram.unsqueeze(0) if single else gram), single


def _argmin(v: torch.Tensor) -> torch.Tensor:
    """Index of the smallest entry of each row of v (N, K), the first on
    ties (as ``jnp.argmin``), by a left-to-right scan."""
    best, idx = v[:, 0], torch.zeros(v.shape[0], dtype=torch.int64, device=v.device)
    for j in range(1, v.shape[-1]):
        take = v[:, j] < best
        best = torch.where(take, v[:, j], best)
        idx = torch.where(take, torch.full_like(idx, j), idx)
    return idx


def min_norm_element(gram: torch.Tensor, iters: int = 250) -> torch.Tensor:
    """Weights w on the simplex minimising wᵀ G w (the MGDA min-norm
    element, reference min_norm_solver.py:109-198): Frank-Wolfe from w = 1/K
    with the exact line search towards the vertex of the smallest gradient
    entry, ``iters`` fixed steps. gram: (K, K) or (N, K, K)."""
    g, single = _batched(gram)
    n, k, _ = g.shape
    w = torch.full((n, k), 1.0 / k, dtype=g.dtype, device=g.device)
    cols = torch.arange(k, device=g.device)
    for _ in range(iters):
        gw = _matvec(g, w)
        e = (cols[None, :] == _argmin(gw)[:, None]).to(g.dtype)
        d = w - e
        num = _dot(d, gw)
        den = _dot(d, _matvec(g, d))
        gamma = torch.clamp(num / (den + EPS), min=0.0, max=1.0).unsqueeze(-1)
        w = (1.0 - gamma) * w + gamma * e
    return w[0] if single else w


def min_norm_every(k: int) -> int:
    """Steps between two of min_norm_solver's compares of w with the step
    before, at K tasks (gaitpd_torch/csrc/mtl_solvers.cu::min_norm_design)."""
    return {5: 8, 6: 8, 8: 2}.get(k, 16)


def min_norm_element_stop(gram: torch.Tensor, every: Optional[int] = None,
                          iters: int = 250) -> Tuple[torch.Tensor, torch.Tensor]:
    """``min_norm_element`` as the kernel min_norm_solver runs it, ended
    after a step s, a multiple of ``every`` (``min_norm_every(K)`` by
    default), that left w's bits unchanged. A step is a fixed function of
    (G, w), so every later step would leave w so too: w is the ``iters``-step
    result, bit for bit. Each step is formed towards every vertex c from w
    alone (d = w - e_c, its G d and d·G d + EPS, d·G w and the division),
    the one of the smallest gradient entry then taken: the same operations
    on the same operands for that vertex, so this form checks the order of
    each sum too. Returns (w, stop): stop (N,) (or a 0-d tensor) is the step
    s at which each matrix stopped, ``iters`` where none did (where the
    kernel reads its compare's verdict one block late, it runs ``every``
    steps past s).
    gram: (K, K) or (N, K, K)."""
    g, single = _batched(gram)
    n, k, _ = g.shape
    every = min_norm_every(k) if every is None else every
    w = torch.full((n, k), 1.0 / k, dtype=g.dtype, device=g.device)
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    cols = torch.arange(k, device=g.device)
    g_rep = g.repeat_interleave(k, dim=0)  # (N K, K, K): one copy a vertex
    stop = torch.full((n,), iters, dtype=torch.int64, device=g.device)
    live = torch.ones(n, dtype=torch.bool, device=g.device)
    for s in range(1, iters + 1):
        gw = _matvec(g, w)
        t = _argmin(gw)
        d = (w[:, None, :] - eye[None]).reshape(n * k, k)  # row c of a matrix: w - e_c
        num = _dot(d, gw.repeat_interleave(k, dim=0))
        den = _dot(d, _matvec(g_rep, d)) + EPS
        gamma = torch.clamp((num / den).reshape(n, k).gather(1, t[:, None]), min=0.0, max=1.0)
        e = (cols[None, :] == t[:, None]).to(g.dtype)
        new = (1.0 - gamma) * w + gamma * e
        if s % every == 0:
            same = live & (new.view(torch.int32) == w.view(torch.int32)).all(-1)
            stop = torch.where(same, torch.full_like(stop, s), stop)
        w = torch.where(live[:, None], new, w)
        if s % every == 0:
            live = live & ~same
            if not bool(live.any()):
                break
    return (w[0], stop[0]) if single else (w, stop)


def _solve(a: List[List[torch.Tensor]], b: List[torch.Tensor]) -> List[torch.Tensor]:
    """x with a x = b for a batch of K x K systems, entries as (N,) tensors:
    Gaussian elimination without pivoting, then back substitution."""
    k = len(b)
    a = [row[:] for row in a]
    b = b[:]
    for p in range(k):
        for r in range(p + 1, k):
            m = a[r][p] / a[p][p]
            for c in range(p + 1, k):
                a[r][c] = a[r][c] - m * a[p][c]
            b[r] = b[r] - m * b[p]
    x: List[torch.Tensor] = [b[0]] * k
    for p in reversed(range(k)):
        s = b[p]
        for c in range(p + 1, k):
            s = s - a[p][c] * x[c]
        x[p] = s / a[p][p]
    return x


def _newton_step(g: torch.Tensor, w: torch.Tensor, f: torch.Tensor, diag: torch.Tensor,
                 damping: float) -> torch.Tensor:
    """max(w - damping · (G + diag(diag) + EPS·I)⁻¹ f, 1e-6)."""
    k = w.shape[-1]
    a = [[g[:, i, j] for j in range(k)] for i in range(k)]
    for i in range(k):
        a[i][i] = (a[i][i] + diag[:, i]) + EPS
    delta = torch.stack(_solve(a, [f[:, i] for i in range(k)]), dim=-1)
    return torch.clamp(w - damping * delta, min=1e-6)


def fairgrad_weights(gram: torch.Tensor, alpha: Union[torch.Tensor, float],
                     iters: int = 100) -> torch.Tensor:
    """Solve G w = w^{-1/alpha}, w >= 0 (reference multitask_weighting.py:
    820-834): damped Newton (step 0.5) on F(w) = G w - w^{-1/alpha} from
    w = 1/K, clipped at 1e-6. The powers go through ``torch.pow`` with a
    tensor exponent, the device's ``powf`` that the kernel calls.
    gram: (K, K) or (N, K, K); alpha: a scalar or (N,)."""
    g, single = _batched(gram)
    n, k, _ = g.shape
    a = torch.as_tensor(alpha, dtype=g.dtype, device=g.device).reshape(-1)
    a = (a.expand(n) if a.numel() == 1 else a.reshape(n)).unsqueeze(-1)  # (N, 1)
    inv_a = torch.ones_like(a) / a
    e1 = -inv_a
    e2 = e1 - 1.0
    w = torch.full((n, k), 1.0 / k, dtype=g.dtype, device=g.device)
    for _ in range(iters):
        f = _matvec(g, w) - torch.pow(w, e1)
        diag = inv_a * torch.pow(w, e2)
        w = _newton_step(g, w, f, diag, 0.5)
    return w[0] if single else w


def nashmtl_weights(gram: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """Solve the Nash-MTL condition G α = 1/α, α > 0 (reference
    multitask_weighting.py:150-243): damped Newton (step 0.8) on
    F(α) = G α - 1/α from α = 1, clipped at 1e-6. gram: (K, K) or
    (N, K, K), already normalised by the caller."""
    g, single = _batched(gram)
    n, k, _ = g.shape
    w = torch.ones((n, k), dtype=g.dtype, device=g.device)
    one = torch.ones_like(w)
    for _ in range(iters):
        f = _matvec(g, w) - one / w
        diag = one / (w * w)
        w = _newton_step(g, w, f, diag, 0.8)
    return w[0] if single else w
