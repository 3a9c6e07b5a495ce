"""Time four lowerings of the windowed rel-pos tile einsums.

Counterpart of the JAX package's ``tools/rel_probe.py``, row for row. Each
lowering turns q, the first nh * hd columns of the packed qkv rows of NW
windows of L = kh * kw tokens, into the windowed kernel's (NW, nh, L,
kh + kw) rel layout, the same values in each:

* ``a_current``: the port's head-split lowering,
  ``models/image_encoder.decomposed_rel_pos_tiles`` on q split by heads;
* ``b_rowmajor``: outputs kept (b, h, w, n, k), one transpose at the end;
* ``c_unrolled``: kh + kw small products on contiguous slices, stacked;
* ``d_bigdot``: one product against the whole (hd, kh^2 + kw^2) bank of
  tiles, then a static row-block gather.

The tiles come from rel-pos tables (2 ws - 1, hd) drawn at scale 0.05
(JAX draws the (ws, ws, hd) tiles themselves: the Toeplitz tiles of a table
take the same time). Before timing, b, c and d are held to a within 5e-2, as
JAX does. Each is timed by ``tools/timing.timed_carry`` (``iters``
applications with the carry mix ``0.9 f(x) + 0.1 x`` in bfloat16; on the
card one CUDA graph replay, beside the same loop launched eagerly) and
printed less the floor of ``x * 1.01``.

Run: python -m sam_quantization_tpu_torch.tools.rel_probe [--model vit_h] [--iters 256]
"""

from __future__ import annotations

import argparse
import sys

import torch

from sam_quantization_tpu_torch.cli import add_platform_arg, device_of
from sam_quantization_tpu_torch.models import image_encoder as ie
from sam_quantization_tpu_torch.models.configs import CONFIGS
from sam_quantization_tpu_torch.models.sam import resolve_device
from sam_quantization_tpu_torch.tools.timing import (blend_mix, device_name, eager_columns,
                                                     timed_carry)

NAMES = ("a_current", "b_rowmajor", "c_unrolled", "d_bigdot")


def out_mix(rel: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(NW, nh, L, kh + kw) -> the carry's shape, every element live
    (``tools/rel_probe.py:68-71``)."""
    r = rel.sum(dim=(1, 3))  # (NW, L)
    return x + r[:, :, None].to(x.dtype) * 0.00099945068359375  # bf16(1e-3)


def lowerings(table_h: torch.Tensor, table_w: torch.Tensor, *, NW: int, nh: int, hd: int,
              ws: int):
    """{name: f(x)} of the four lowerings for x (NW, L, nh * hd) and the rel
    tables (2 ws - 1, hd) in x's dtype."""
    kh = kw = ws
    L = kh * kw
    Rh = ie.get_rel_pos(kh, kh, table_h)  # (kh, kh, hd)
    Rw = ie.get_rel_pos(kw, kw, table_w)

    def a_current(x):
        q = x.reshape(NW, L, nh, hd).transpose(1, 2).reshape(NW * nh, L, hd)
        rel_h, rel_w = ie.decomposed_rel_pos_tiles(q, table_h, table_w, (kh, kw), (kh, kw))
        rel = torch.cat([rel_h, rel_w], -1).reshape(NW, nh, L, kh + kw)
        return out_mix(rel, x)

    def b_rowmajor(x):
        qg = x.reshape(NW, kh, kw, nh, hd)
        rel_h = torch.einsum("bhwnc,hkc->bhwnk", qg, Rh)
        rel_w = torch.einsum("bhwnc,wkc->bhwnk", qg, Rw)
        rel = torch.cat([rel_h, rel_w], -1)  # (NW, kh, kw, nh, 2 ws)
        rel = rel.reshape(NW, L, nh, kh + kw).transpose(1, 2)
        return out_mix(rel, x)

    def c_unrolled(x):
        qg = x.reshape(NW, kh, kw, nh, hd)
        rel_h = torch.stack([torch.matmul(qg[:, h], Rh[h].t()) for h in range(kh)], dim=1)
        rel_w = torch.stack([torch.matmul(qg[:, :, w], Rw[w].t()) for w in range(kw)], dim=2)
        rel = torch.cat([rel_h, rel_w], -1)
        rel = rel.reshape(NW, L, nh, kh + kw).transpose(1, 2)
        return out_mix(rel, x)

    bank = torch.cat([Rh.reshape(kh * kh, hd).t(), Rw.reshape(kw * kw, hd).t()], dim=1)
    ih = torch.arange(kh, device=table_h.device)
    iw = torch.arange(kw, device=table_h.device)

    def d_bigdot(x):
        full = torch.matmul(x.reshape(NW, L, nh, hd), bank)  # (NW, L, nh, kh^2 + kw^2)
        fh = full[..., : kh * kh].reshape(NW, kh, kw, nh, kh, kh)
        fw = full[..., kh * kh:].reshape(NW, kh, kw, nh, kw, kw)
        # rows (h, w) keep bank h of the h-tiles and bank w of the w-tiles
        rel_h = fh[:, ih, :, :, ih].movedim(0, 1)  # (NW, kh, kw, nh, kh)
        rel_w = fw[:, :, iw, :, iw].movedim(0, 2)  # (NW, kh, kw, nh, kw)
        rel = torch.cat([rel_h, rel_w], -1)
        rel = rel.reshape(NW, L, nh, kh + kw).transpose(1, 2)
        return out_mix(rel, x)

    return dict(zip(NAMES, (a_current, b_rowmajor, c_unrolled, d_bigdot)))


def main(argv=None) -> int:
    measure(argv)
    return 0


def measure(argv=None):
    """Run the probe; returns (the floor's Carried, [(lowering, Carried)])."""
    ap = argparse.ArgumentParser("rel_probe")
    ap.add_argument("--model", default="vit_h", choices=sorted(CONFIGS))
    ap.add_argument("--iters", type=int, default=256)
    add_platform_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(device_of(args))

    ecfg = CONFIGS[args.model].image_encoder
    ws, G, nh, hd = ecfg.window_size, ecfg.grid_size, ecfg.num_heads, ecfg.head_dim
    NW = ((G + ws - 1) // ws) ** 2
    L = ws * ws
    gen = torch.Generator(device=device).manual_seed(0)

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    table_h = mk(2 * ws - 1, hd) * 0.05
    table_w = mk(2 * ws - 1, hd) * 0.05
    xq = mk(NW, L, nh * hd)
    fns = lowerings(table_h, table_w, NW=NW, nh=nh, hd=hd, ws=ws)

    floor = timed_carry(lambda x: x * 1.0078125, xq, args.iters, blend_mix, name="scan floor")
    print(f"[rel probe] NW={NW} L={L} nh={nh} hd={hd} kh=kw={ws} on {device_name(device)}")
    print(f"  scan floor            {floor.ms:7.3f} ms" + eager_columns(floor), flush=True)

    # numerics cross-check first: bf16 reassociation, a few ulps
    with torch.no_grad():
        ra = fns["a_current"](xq).float()
        for name in NAMES[1:]:
            err = float((ra - fns[name](xq).float()).abs().max())
            if not err < 5e-2:
                raise AssertionError(f"{name}: max |d| {err} against a_current")

    rows = []
    for name in NAMES:
        t = timed_carry(fns[name], xq, args.iters, blend_mix, name=name)
        print(f"  {name:20s} {t.ms - floor.ms:7.3f} ms" + eager_columns(t, floor), flush=True)
        rows.append((name, t))
    return floor, rows


if __name__ == "__main__":
    sys.exit(main())
