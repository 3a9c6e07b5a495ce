"""Device times of the attention kernels at ViT-H.

    python -m sam_quantization_tpu_torch.tools.attention_timing [--iters 50]

Times ``flash_windowed`` (25 windows of 14 x 14, 16 heads, hd 80) and
``flash_global`` (a 64 x 64 grid, 16 heads, hd 80) at one image's shapes,
bf16 out and int8 out; ``flash_whole`` in bf16 at the same windows split
into heads, (25, 16, 196, 80), with 14 + 14 rel tiles and rel-less;
``flash_rowblock`` in bf16 at the rel-less global shape (1, 16, 4096, 80);
all at scale hd**-0.5, each beside ``scaled_dot_product_attention`` at the
same scale (the rel bias as ``attn_mask``); ``flash_whole`` and
``flash_rowblock`` also in float32 at the same shapes (the trainer's build),
beside SDPA in float32; ``flash_windowed`` and ``flash_global`` also in
float32 (the evaluation path's encode), float and int8 out, beside SDPA in
float32 (``sdpa_whole_f32`` is the windowed yardstick: the same heads and
mask shape). And the stage probes' kernels: ``probe_no_softmax``
(P1) on 25 windows of the packed qkv, heads read in place, with 14 + 14 rel
columns, beside two ``torch.bmm`` on the heads split beforehand; and, at
the probes' shapes, ``probe_dots_floor`` (P2) on ``packed_probe``'s
unscaled (400, 256, 128) heads beside two ``torch.bmm``;
``probe_presplit`` (P3, exp2 and exp) on (400, 256, 128), ``probe_pair``
(P4, row max and clamp 40) and ``probe_pair_bias`` (P5, the same with raw
64 x 64 rel tiles) on (16, 4096, 128), q scaled by hd**-0.5 * log2(e) as
the probes scale it, each beside its yardstick
``scaled_dot_product_attention`` with scale ln 2 (the exp2 softmax; P5's
bias times ln 2 as ``attn_mask``). Inputs
are random, made from ``--seed``. It prints one JSON line with the card's
name, its power limit and the ms per call
(:func:`sam_quantization_tpu_torch.tools.timing.timed_ms`). Run it from two
checkouts in one session to compare two versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch
import torch.nn.functional as F

from sam_quantization_tpu_torch.ops import flash_attention as fa
from sam_quantization_tpu_torch.ops import probes
from sam_quantization_tpu_torch.tools.timing import timed_ms


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    nh, hd, ws, g, nw = 16, 80, 14, 64, 25
    C, Lw, Lg, scale = nh * hd, ws * ws, g * g, hd**-0.5
    qkv, rel = randn(nw, Lw, 3 * C), randn(nw, nh, Lw, 2 * ws)
    q, k, v = (randn(1, nh, Lg, hd) for _ in range(3))
    rh, rw = randn(1, nh, Lg, g), randn(1, nh, Lg, g)
    wq, wk, wv = (randn(nw, nh, Lw, hd) for _ in range(3))
    wrh, wrw = randn(nw, nh, Lw, ws), randn(nw, nh, Lw, ws)
    n = torch.arange(Lw, device=dev)
    wmask = (wrh[..., n // ws] + wrw[..., n % ws]).contiguous()
    f32 = [t.float() for t in (wq, wk, wv, wrh, wrw, wmask, q, k, v)]
    qkv32, rel32, rh32, rw32 = (t.float() for t in (qkv, rel, rh, rw))
    ng = torch.arange(Lg, device=dev)
    gmask32 = (rh32[..., ng // g] + rw32[..., ng % g]).contiguous()
    win = dict(nh=nh, hd=hd, kh=ws, kw=ws)
    ois = 127.0 / 4.0
    cases = {
        "flash_windowed": lambda: fa.flash_attention_qkv_packed(qkv, rel, scale, **win),
        "flash_windowed_int8": lambda: fa.flash_attention_qkv_packed(
            qkv, rel, scale, out_inv_scale=ois, **win),
        "flash_global": lambda: fa.flash_attention_relpos(q, k, v, rh, rw, scale),
        "flash_global_int8": lambda: fa.flash_attention_relpos(
            q, k, v, rh, rw, scale, out_inv_scale=ois),
        "flash_whole": lambda: fa.flash_attention_relpos(wq, wk, wv, wrh, wrw, scale),
        "flash_whole_norel": lambda: fa.flash_attention_relpos(wq, wk, wv, None, None, scale),
        "sdpa_whole": lambda: F.scaled_dot_product_attention(wq, wk, wv, attn_mask=wmask,
                                                             scale=scale),
        "sdpa_whole_norel": lambda: F.scaled_dot_product_attention(wq, wk, wv, scale=scale),
        "flash_rowblock": lambda: fa.flash_attention_relpos(q, k, v, None, None, scale),
        "sdpa_rowblock": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
        "flash_whole_f32": lambda: fa.flash_attention_relpos(*f32[:5], scale),
        "flash_whole_f32_norel": lambda: fa.flash_attention_relpos(*f32[:3], None, None, scale),
        "sdpa_whole_f32": lambda: F.scaled_dot_product_attention(*f32[:3], attn_mask=f32[5],
                                                                 scale=scale),
        "sdpa_whole_f32_norel": lambda: F.scaled_dot_product_attention(*f32[:3], scale=scale),
        "flash_rowblock_f32": lambda: fa.flash_attention_relpos(*f32[6:], None, None, scale),
        "sdpa_rowblock_f32": lambda: F.scaled_dot_product_attention(*f32[6:], scale=scale),
        "flash_windowed_f32": lambda: fa.flash_attention_qkv_packed(qkv32, rel32, scale, **win),
        "flash_windowed_f32_int8": lambda: fa.flash_attention_qkv_packed(
            qkv32, rel32, scale, out_inv_scale=ois, **win),
        "flash_global_f32": lambda: fa.flash_attention_relpos(*f32[6:], rh32, rw32, scale),
        "flash_global_f32_int8": lambda: fa.flash_attention_relpos(
            *f32[6:], rh32, rw32, scale, out_inv_scale=ois),
        "sdpa_global_f32": lambda: F.scaled_dot_product_attention(*f32[6:], attn_mask=gmask32,
                                                                  scale=scale),
    }
    # P1 on the packed qkv of the windowed stage, 14 + 14 rel columns.
    prel = (torch.randn((nw, nh, Lw, 2 * ws), generator=gen, device=dev) * 0.05).to(bf)
    heads = [qkv[..., i * C:(i + 1) * C].reshape(nw, Lw, nh, hd).transpose(1, 2)
             .reshape(nw * nh, Lw, hd).contiguous() for i in range(3)]
    cases.update({
        "probe_no_softmax": lambda: probes.probe_no_softmax(
            qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], prel, scale, nh=nh, hd=hd),
        "bmm2_no_softmax": lambda: torch.bmm(torch.bmm(heads[0], heads[1].transpose(1, 2)),
                                             heads[2]),
    })
    # The probes' head shapes (hd 80 padded to 128 lanes; random in all 128);
    # P2 takes q unscaled, as tools/packed_probe.py does.
    pq, pk, pv = (randn(400, 256, 128) for _ in range(3))
    gq, gk, gv = (randn(16, Lg, 128) for _ in range(3))
    pq_raw = pq
    pq, gq = ((t.float() * (scale * fa.LOG2E)).to(bf) for t in (pq, gq))

    # P5's raw rel tiles, at the probe's scale, and their bias as SDPA's mask.
    prh, prw = ((torch.randn((16, Lg, g), generator=gen, device=dev) * 0.05).to(bf)
                for _ in range(2))
    n = torch.arange(Lg, device=dev)
    mask = ((prw.float()[..., n % g] + prh.float()[..., n // g]) * math.log(2.0)).to(bf)[None]

    def sdpa(q3, k3, v3, mask=None):
        q4, k4, v4 = (t[None] for t in (q3, k3, v3))
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                      scale=math.log(2.0))

    cases.update({
        "probe_dots_floor": lambda: probes.probe_dots_floor(pq_raw, pk, pv),
        "bmm2_dots_floor": lambda: torch.bmm(torch.bmm(pq_raw, pk.transpose(1, 2)), pv),
        "probe_presplit_exp2": lambda: probes.probe_presplit(pq, pk, pv, True),
        "probe_presplit_exp": lambda: probes.probe_presplit(pq, pk, pv, False),
        "sdpa_presplit": sdpa(pq, pk, pv),
        "probe_pair_rowmax": lambda: probes.probe_pair(gq, gk, gv, False),
        "probe_pair_clamp": lambda: probes.probe_pair(gq, gk, gv, True),
        "sdpa_pair": sdpa(gq, gk, gv),
        "probe_pair_bias_rowmax": lambda: probes.probe_pair_bias(gq, gk, gv, prh, prw, False),
        "probe_pair_bias_clamp": lambda: probes.probe_pair_bias(gq, gk, gv, prh, prw, True),
        "sdpa_pair_bias": sdpa(gq, gk, gv, mask),
    })
    line = {"gpu": card_line()}
    for name, fn in cases.items():
        line[f"{name}_ms"] = timed_ms(fn, args.iters, dev, args.repeats)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
