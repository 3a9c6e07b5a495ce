"""GPTQ weight-only quantization solver in PyTorch.

Counterpart of ``sam_quantization_tpu/quant/gptq.py`` (itself after the
reference's ``gptq.py``, from IST-DASLab/gptq): given a layer's Hessian
``H = (2/B) Σ xᵀx``, a damped Cholesky inverse, then block by block,
column by column quantization with error feedback, optional activation
ordering (``actorder``) and per-group scale and zero.

The block semantics are the JAX solver's, not the reference's per-column
group test (the two agree when ``groupsize % blocksize == 0``): a group's
parameters are found once, at its first block, over the whole group-wide
slice of the error-fed weights; inside a block each column's error feeds
the block's later columns; after the block ``w -= err1 @ hinv_rows`` on
every later column; ``loss = Σ err1² / 2``.

The solver is plain PyTorch and runs on the device of its inputs. The
column loop is a host loop of a few elementwise launches a column; it
keeps the transposed weight ``(K, N)``, so that column ``k`` is the
contiguous row ``k``. The Cholesky chain and the block-tail products run in
float64 and round once to float32. Those are the sums whose order depends
on the library (the CPU's LAPACK and BLAS, or cuSOLVER and cuBLAS), and the
error feedback carries a last-bit difference in them into whole grid steps
of later columns. Rounded from float64, they come out the same on the card
and on the CPU, and so does the grid for the same H. The updates
``a - b * c`` round the product before the difference on both devices
(``addcmul`` is a fused multiply-add on the CPU and not on the card).

Two rewrites XLA makes inside the jitted JAX solver are made here too, so
that the two agree bit for bit where no error crosses columns: a division
by a constant becomes a multiplication by its float32 reciprocal (the
``/ maxq`` of every grid), and the MSE search's shrink factor
``1 - i / grid * maxshrink`` is one fused multiply-add by a folded
constant. ``torch.round`` rounds half to even, as ``jnp.round`` does, and
the actorder permutation is a stable argsort, as ``jnp.argsort`` is (dead
columns tie).

Weight orientation: ``w`` is ``(N out, K in)``, the port's ``Linear.weight``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GPTQConfig:
    """The quantization grid (``bits``, ``groupsize`` -1 or 0: one group over
    all of K, ``sym``: symmetric grid with a mid-point zero) and the solver's
    knobs (``actorder``, ``percdamp``, ``blocksize``, and the MSE grid-shrink
    search ``mse`` / ``maxshrink`` / ``grid`` / ``norm``)."""

    bits: int = 4
    groupsize: int = -1
    sym: bool = False
    actorder: bool = False
    percdamp: float = 0.01
    blocksize: int = 128
    mse: bool = False
    maxshrink: float = 0.8
    grid: int = 100
    norm: float = 2.4

    @property
    def maxq(self) -> int:
        return (1 << self.bits) - 1


class GPTQResult(NamedTuple):
    q_int: torch.Tensor  # (N, K) int32 grid values
    scales: torch.Tensor  # (N, G)
    zeros: torch.Tensor  # (N, G)
    loss: torch.Tensor  # scalar Σ err² / 2
    g_idx: torch.Tensor  # (K,) int32 group of each original column (with
    #   actorder the groups follow the permuted order)


def _recip(c: float) -> float:
    """The float32 reciprocal of ``c``, as XLA folds ``x / c`` into ``x * (1/c)``."""
    return float(np.float32(1.0) / np.float32(c))


def find_params(
    w: torch.Tensor, maxq: int, sym: bool, mse: bool = False,
    maxshrink: float = 0.8, grid: int = 100, norm: float = 2.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row min-max (optionally MSE-shrunk) grid ``(scale, zero)`` of
    (N, k) weights (reference ``Quantizer.find_params``). An all-zero row
    gets the grid of [-1, 1]."""
    wmin = torch.clamp(w.amin(dim=1), max=0.0)
    wmax = torch.clamp(w.amax(dim=1), min=0.0)
    if sym:
        wmax = torch.maximum(wmin.abs(), wmax)
        wmin = torch.where(wmin < 0, -wmax, wmin)
    degenerate = (wmin == 0) & (wmax == 0)
    wmin = torch.where(degenerate, -1.0, wmin)
    wmax = torch.where(degenerate, 1.0, wmax)
    inv_maxq = _recip(maxq)
    scale = (wmax - wmin) * inv_maxq
    zero = torch.full_like(scale, (maxq + 1) / 2) if sym else torch.round(-wmin / scale)
    if mse:
        # One candidate at a time, keeping the first of equal errors (argmin's rule).
        best = torch.full_like(scale, float("inf"))
        best_s, best_z = scale, zero
        step = float(np.float32(_recip(grid)) * np.float32(maxshrink))  # XLA folds / grid * maxshrink
        for i in range(grid):
            p = float(np.float32(1.0 - i * step))  # one rounding: XLA fuses it into an FMA
            s = p * (wmax - wmin) * inv_maxq
            z = zero if sym else torch.round(-p * wmin / s)
            q = torch.clamp(torch.round(w / s[:, None]) + z[:, None], 0, maxq)
            err = (s[:, None] * (q - z[:, None]) - w).abs().pow(norm).sum(dim=1)
            take = err < best
            best = torch.where(take, err, best)
            best_s = torch.where(take, s, best_s)
            best_z = torch.where(take, z, best_z)
        scale, zero = best_s, best_z
    return scale, zero


def _prepare_hinv(h: torch.Tensor, percdamp: float) -> torch.Tensor:
    """Dead columns get a unit diagonal, then damp, Cholesky inverse, and the
    upper factor ``U`` of ``H⁻¹`` (``UᵀU = H⁻¹``; reference gptq.py:89-97),
    in float64, rounded once to float32."""
    h = h.double()  # a copy
    diag = h.diagonal()
    diag.add_((diag == 0).double())
    diag.add_(percdamp * diag.mean())
    eye = torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
    hinv = torch.cholesky_solve(eye, torch.linalg.cholesky(h))
    return torch.linalg.cholesky(hinv).T.float().contiguous()


def gptq_quantize_matrix(
    w: torch.Tensor,
    h: torch.Tensor,
    *,
    bits: int,
    groupsize: int = -1,
    sym: bool = False,
    actorder: bool = False,
    percdamp: float = 0.01,
    blocksize: int = 128,
    mse: bool = False,
) -> GPTQResult:
    """Quantize ``w`` (N, K) given the Hessian ``h`` (K, K) (reference
    ``fasterquant``, gptq.py:62-171), on their device."""
    N, K = w.shape
    maxq = (1 << bits) - 1
    w = w.float()
    h = h.float()
    dead = h.diagonal() == 0
    w = w.masked_fill(dead[None, :], 0.0)
    if actorder:
        perm = torch.argsort(-h.diagonal(), stable=True)
        w = w[:, perm]
        h = h[perm][:, perm]
        invperm = torch.argsort(perm)
    hinv = _prepare_hinv(h, percdamp)
    hinv64 = hinv.double()  # the block tails' factor, exactly

    g = groupsize if groupsize > 0 else K
    g = min(g, K)  # a group never exceeds the K axis (tiny layers)
    bs = min(blocksize, g, K)
    if K % bs or g % bs or K % g:
        raise ValueError(f"K={K} needs whole groups of {g} and blocks of {bs}")
    G = K // g

    wt = w.t().contiguous()  # (K, N): the loop's column k is row k
    q_t = torch.empty_like(wt)
    scales = torch.empty((G, N), dtype=torch.float32, device=w.device)
    zeros = torch.empty_like(scales)
    loss = torch.zeros((), dtype=torch.float32, device=w.device)
    err1 = torch.empty((bs, N), dtype=torch.float32, device=w.device)
    for i1 in range(0, K, bs):
        i2 = i1 + bs
        if i1 % g == 0:
            # Found once a group, from the error-fed weights of all its columns.
            scale, zero = find_params(wt[i1:i1 + g].t(), maxq, sym, mse)
            scales[i1 // g], zeros[i1 // g] = scale, zero
        w1 = wt[i1:i2]
        hinv1 = hinv[i1:i2, i1:i2]
        d = hinv1.diagonal()
        for j in range(bs):
            col = w1[j]
            q = torch.clamp(torch.round(col / scale) + zero, 0, maxq, out=q_t[i1 + j])
            err = torch.div(col - scale * (q - zero), d[j], out=err1[j])
            if j + 1 < bs:  # error feedback onto the block's later columns
                w1[j + 1:] -= hinv1[j, j + 1:, None] * err
        loss += (err1 * err1).sum() / 2
        if i2 < K:
            wt[i2:] -= (hinv64[i1:i2, i2:].t() @ err1.double()).float()

    q_int = q_t.t().to(torch.int32)
    g_idx = torch.arange(K, dtype=torch.int32, device=w.device) // g
    if actorder:
        q_int = q_int[:, invperm]
        # Original column k sat at permuted position invperm[k], so its group
        # is invperm[k] // g; consumers gather scales and zeros through g_idx.
        g_idx = (invperm // g).to(torch.int32)
    return GPTQResult(q_int=q_int.contiguous(), scales=scales.t().contiguous(),
                      zeros=zeros.t().contiguous(), loss=loss, g_idx=g_idx)


def reconstruct(res: GPTQResult) -> torch.Tensor:
    """Dequantized (N, K) weights of a solver result (group parameters
    gathered per column through ``g_idx``, so actorder layouts dequantize
    right)."""
    idx = res.g_idx.long()
    return (res.q_int.float() - res.zeros[:, idx]) * res.scales[:, idx]
