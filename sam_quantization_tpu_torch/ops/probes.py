"""Attention ablation kernels of the stage probes: CUDA kernels and their
plain PyTorch versions.

Counterparts of the five Pallas functions of the JAX package's TPU stage
probes, which strip the serving attention kernels down to their parts
(``tools/packed_probe.py``, ``tools/global_stage_probe.py``):

* :func:`probe_no_softmax` - the windowed kernel's dots without its softmax,
  on heads read from the packed projection output (replaces
  ``_kernel_no_softmax``; ``csrc/probe_packed.cu``);
* :func:`probe_dots_floor` - ``round(q.k) . v`` on pre-split heads (replaces
  ``_kernel_dots_floor``);
* :func:`probe_presplit` - row-max softmax attention on pre-split heads,
  ``exp2`` or ``exp`` (replaces ``_kernel_presplit``);
* :func:`probe_pair` - the same with ``exp2`` only, or with the static shift
  ``exp2(min(s, 40) - 40)`` (replaces ``_k_pair``);
* :func:`probe_pair_bias` - :func:`probe_pair` with the decomposed rel-pos
  bias ``rw[n % kw] + rh[n // kw]`` of raw tiles added in float32 (replaces
  ``_k_pair_bias``).

All five run one body, ``csrc/probe_tc.cuh``: both products on the tensor
cores (``wgmma``), q, K and V by TMA. The last four are one entry point of
``csrc/probe_heads.cu``; the wrapper pads a head dim that is not a multiple
of 8 with zeros and copies an operand that is not 16-byte aligned, as those
copies need. :func:`probe_no_softmax` (``csrc/probe_packed.cu``) reads its
heads in place through 4D tensor maps and adds the rel columns as more q.k
depth; :func:`aug_operands` gives its operands as those copies take them. :func:`probe_dots_floor` makes one pass and rounds s to bf16
straight into the p.v operand. :func:`probe_presplit`, :func:`probe_pair`
and :func:`probe_pair_bias` (the row-max and clamp-40 softmax, with and
without the bias) take the row max exact by a first q.k pass (the bias
added in both passes), and IEEE gradual underflow in p as the plain version
has it, so a clamp-40 row whose logits all lie in (-109, -86) stays finite
on both. None of them scales q: the callers prescale it where they want a
scale (the probes pass ``q * hd**-0.5 * log2(e)`` to the pair kernels),
and a key padded with zeros is a key like any other. ``halves`` and
``block_q`` of the TPU kernels split rows between independent chains for
the TPU's scheduler; rows are independent, so they change no number and
have no counterpart.

Each wrapper launches its kernel for a CUDA tensor (bfloat16, as the probes
run) and uses the plain version only for a CPU tensor. ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

from typing import Dict

import torch

from sam_quantization_tpu_torch.ops import _build

LAUNCHES: Dict[str, int] = {
    "probe_no_softmax": 0, "probe_dots_floor": 0, "probe_presplit": 0, "probe_pair": 0,
    "probe_pair_bias": 0,
}
PAIR_CAP = 40.0  # the static shift of _k_pair / _k_pair_bias
_NONE, _ROWMAX, _CLAMP = 0, 1, 2  # csrc/probe_heads.cu's modes


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")


# ---------------------------------------------------------------------------
# P1: windowed dots without the softmax, heads read from the packed layout
# ---------------------------------------------------------------------------


def probe_no_softmax_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel: torch.Tensor, scale: float, *, nh: int, hd: int) -> torch.Tensor:
    """Plain PyTorch version of ``probe_packed`` (same math, same order)."""
    NW, L, C = q.shape
    dt = q.dtype

    def split(t):  # (NW, L, nh*hd) -> (NW, nh, L, hd)
        return t.reshape(NW, L, nh, hd).transpose(1, 2)

    qs = (split(q).float() * scale).to(dt)
    qa = torch.cat([qs, rel], -1).float()
    ka = torch.cat([split(k), rel], -1).float()
    s = torch.matmul(qa, ka.transpose(-1, -2))
    o = torch.matmul(s.to(dt).float(), split(v).float())
    return o.to(dt).transpose(1, 2).reshape(NW, L, C)


def aug_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel: torch.Tensor, *,
                 nh: int, hd: int):
    """``(q, k, v, rel, hd')``: P1's operands as ``csrc/probe_packed.cu``'s
    TMA copies take them. q, k and v are read in place where hd and their
    row and window strides are multiples of 8 elements and each starts on 16
    bytes; otherwise they are copied to (NW, L, nh*hd') with each head
    zero-padded to hd' = hd rounded up to 8. rel's R is zero-padded to a
    multiple of 8 (rows of whole 16-byte groups). Zero columns add nothing to
    q.k, and the output columns of a padded head past hd are zeros, which the
    caller cuts."""
    NW, L, _ = q.shape
    in_place = (hd % 8 == 0 and q.stride(0) % 8 == 0 and q.stride(1) % 8 == 0
                and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    if not in_place:
        hdp = hd + -hd % 8

        def padded(t):
            out = t.new_zeros((NW, L, nh, hdp))
            out[..., :hd] = t.reshape(NW, L, nh, hd)
            return out.reshape(NW, L, nh * hdp)

        q, k, v, hd = padded(q), padded(k), padded(v), hdp
    (rel,) = _build.tma_operands(rel)
    return q, k, v, rel, hd


def probe_no_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel: torch.Tensor,
                     scale: float, *, nh: int, hd: int) -> torch.Tensor:
    """Per window and head, ``round(s) . v`` with
    ``s = [round(q * scale) | rel] . [k | rel]`` (the same rel rows on both
    sides), no softmax, no normalisation.

    Args:
      q, k, v: (NW, L, nh*hd), head h at columns h*hd; slices of the packed
        qkv output are read in place (the last dim must be contiguous and the
        three must share their strides).
      rel: (NW, nh, L, R), the rel tiles of each row.
      scale: the multiplier of q.

    Returns (NW, L, nh*hd) in q's dtype.
    """
    NW, L, C = q.shape
    if (C != nh * hd or tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape)
            or rel.dim() != 4 or tuple(rel.shape[:3]) != (NW, nh, L)):
        raise ValueError(f"probe_no_softmax: q {tuple(q.shape)}, rel {tuple(rel.shape)} do not "
                         f"fit nh={nh} hd={hd}")
    if q.device.type == "cpu":
        return probe_no_softmax_plain(q, k, v, rel, scale, nh=nh, hd=hd)
    if q.device.type != "cuda":
        raise ValueError(f"probe_no_softmax: no kernel for {q.device}")
    _cuda_operands("probe_no_softmax", q, k, v, rel)
    if q.stride(2) != 1 or k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("probe_no_softmax: q, k, v need a contiguous last dim and equal strides")
    if not rel.is_contiguous():
        raise ValueError("probe_no_softmax: rel must be contiguous")
    if hd > 128 or rel.shape[3] > 128:
        raise ValueError(f"probe_no_softmax: head dim {hd} or rel width {rel.shape[3]} > 128")
    q, k, v, rel, hdk = aug_operands(q, k, v, rel, nh=nh, hd=hd)
    out = torch.empty((NW, L, nh * hdk), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch(
            "probe_packed", q.data_ptr(), k.data_ptr(), v.data_ptr(), rel.data_ptr(),
            out.data_ptr(), NW, L, nh, hdk, rel.shape[3], q.stride(1), q.stride(0), float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    if hdk != hd:
        out = out.reshape(NW, L, nh, hdk)[..., :hd].reshape(NW, L, C)
    LAUNCHES["probe_no_softmax"] += 1
    return out


# ---------------------------------------------------------------------------
# P2-P5: pre-split heads (..., L, D)
# ---------------------------------------------------------------------------


def _rows_softmax_pv(s: torch.Tensor, v: torch.Tensor, dt, clamp: bool, exp2: bool = True):
    """``(round(p) . v) * (1 / sum p)``: ``p = exp2(min(s, 40) - 40)`` with
    ``clamp``, else ``exp2(s - max s)`` (``exp`` without ``exp2``)."""
    if clamp:
        p = torch.exp2(torch.clamp_max(s, PAIR_CAP) - PAIR_CAP)
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m) if exp2 else torch.exp(s - m)
    r = 1.0 / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(dt).float(), v.float())
    return (o * r).to(dt)


def _logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def probe_dots_floor_plain(q, k, v) -> torch.Tensor:
    """Plain version of P2: ``round(q.k) . v``, rounded to q's dtype."""
    return torch.matmul(_logits(q, k).to(q.dtype).float(), v.float()).to(q.dtype)


def probe_presplit_plain(q, k, v, exp2: bool = True) -> torch.Tensor:
    """Plain version of P3: row-max softmax, deferred normalisation."""
    return _rows_softmax_pv(_logits(q, k), v, q.dtype, clamp=False, exp2=exp2)


def probe_pair_plain(q, k, v, clamp: bool) -> torch.Tensor:
    """Plain version of P4: the clamp-40 or the row-max exp2 softmax."""
    return _rows_softmax_pv(_logits(q, k), v, q.dtype, clamp=clamp)


def probe_pair_bias_plain(q, k, v, rh, rw, clamp: bool) -> torch.Tensor:
    """Plain version of P5: P4 on ``s + (rw[n % kw] + rh[n // kw])``."""
    L, kw = q.shape[-2], rw.shape[-1]
    n = torch.arange(L, device=q.device)
    s = _logits(q, k) + (rw.float()[..., n % kw] + rh.float()[..., n // kw])
    return _rows_softmax_pv(s, v, q.dtype, clamp=clamp)


def _heads(name: str, mode: int, exp2: bool, q, k, v, rh=None, rw=None) -> torch.Tensor:
    """Launch csrc/probe_heads.cu on (..., L, D) operands."""
    L, D = q.shape[-2:]
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    kh = kw = 0
    if rh is not None:
        kh, kw = rh.shape[-1], rw.shape[-1]
        lead = tuple(q.shape[:-1])
        if tuple(rh.shape[:-1]) != lead or tuple(rw.shape[:-1]) != lead or kh * kw != L:
            raise ValueError(f"{name}: rel tiles {tuple(rh.shape)}, {tuple(rw.shape)} do not fit "
                             f"a kh x kw == L={L} grid")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    bias = () if rh is None else (rh, rw)
    _cuda_operands(name, q, k, v, *bias)
    if not all(t.is_contiguous() for t in (q, k, v, *bias)):
        raise ValueError(f"{name}: operands must be contiguous")
    if D > 128:
        raise ValueError(f"{name}: head dim {D} > 128")
    # csrc/probe_tc.cuh takes q, k and v by TMA (rh and rw are read a value
    # at a time and need neither).
    q, k, v = _build.tma_operands(q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.launch(
            "probe_heads", mode, int(exp2), int(rh is not None), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), None if rh is None else rh.data_ptr(),
            None if rw is None else rw.data_ptr(), out.data_ptr(), q.numel() // (L * q.shape[-1]),
            L, q.shape[-1], kh, kw, torch.cuda.current_stream().cuda_stream,
        )
    if out.shape[-1] != D:
        out = out[..., :D].contiguous()
    LAUNCHES[name] += 1
    return out


def probe_dots_floor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P2: ``round(q.k) . v`` on (..., L, D) heads, no scale, no softmax."""
    if q.device.type == "cpu":
        return probe_dots_floor_plain(q, k, v)
    return _heads("probe_dots_floor", _NONE, True, q, k, v)


def probe_presplit(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   exp2: bool = True) -> torch.Tensor:
    """P3: ``(round(p) . v) / sum p`` with ``p = exp2(s - max s)`` (``exp``
    without ``exp2``), ``s = q.k`` unscaled, over all L keys."""
    if q.device.type == "cpu":
        return probe_presplit_plain(q, k, v, exp2)
    return _heads("probe_presplit", _ROWMAX, exp2, q, k, v)


def probe_pair(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, clamp: bool) -> torch.Tensor:
    """P4: as :func:`probe_presplit` with exp2, or with ``clamp`` the static
    shift ``p = exp2(min(s, 40) - 40)`` (no floor: a row whose every logit
    lies far below 40 sums to 0 and gives NaN, as the TPU kernel does)."""
    if q.device.type == "cpu":
        return probe_pair_plain(q, k, v, clamp)
    return _heads("probe_pair", _CLAMP if clamp else _ROWMAX, True, q, k, v)


def probe_pair_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rh: torch.Tensor,
                    rw: torch.Tensor, clamp: bool) -> torch.Tensor:
    """P5: :func:`probe_pair` on ``s + (rw[n % kw] + rh[n // kw])``, the raw
    (not log2 e-scaled) tiles rh (..., L, kh) and rw (..., L, kw) added in
    float32; kh * kw == L."""
    if q.device.type == "cpu":
        return probe_pair_bias_plain(q, k, v, rh, rw, clamp)
    return _heads("probe_pair_bias", _CLAMP if clamp else _ROWMAX, True, q, k, v, rh, rw)
