"""Simplex solvers of the multitask weighting, in plain PyTorch.
Port of gaitpd/learning/minnorm.py:19-122 (``project_simplex`` and
``cagrad_weights``).

Both take a batch of problems along the leading axis as well as a single
one: the solver's loops are fixed and elementwise across problems, so one
call solves many at the cost of one. On the training path the CAGrad weights
come from the CUDA kernel of gaitpd_torch/ops/cagrad_solver.py; the function
here is its plain version (CPU tensors, and the comparison on the card).
Its sums are written out term by term, in the kernel's order, and every
step is one IEEE operation, so the two agree bit for bit; against gaitpd
they agree to the rounding of the sums (see tests/test_torch_minnorm.py).
``min_norm_element``, ``fairgrad_weights`` and ``nashmtl_weights`` wait for
the other MTL methods (ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

from typing import Union

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
