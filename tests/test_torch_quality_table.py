"""Port parity: the quantization-quality table (``tools/quality_table.py``)
against the JAX package's, on the CPU, on ``checkpoints/vit_tiny_synth``.

Both tools' ``main`` write their table at small settings (4 scenes, 2
calibration scenes, 3 clicks, NoC to 4), the JAX tool once for all eight
configurations. Each package's click loops are wrapped to keep their
per-scene IoUs. The configurations both packages quantize to the same
weights (RTN and its layerwise SNR are deterministic), ``fp32``,
``rtn_int4``, ``rtn_int2u_mixed`` and ``bf16_kernels``, hold the same keys,
click-k mIoU within 1e-3, NoC and its CI95 equal unless a scene's NoC
differs where one of its IoUs lies within 1e-3 of the threshold (the check
says so), and each click CI95 bound within the largest per-scene IoU gap at
that click plus the 1e-4 rounding (a bound is a mean of resampled scenes).

The requantized rows, ``gptq_int4``, ``gptq_int3``, ``a8_serving`` and
``fq_int8``: the two packages' GPTQ solvers and FQ calibrations sum in
other float32 orders, and GPTQ feeds each flip's error forward: on this
checkpoint the port's grids differ from JAX's on 0.3% (W4), 1.2% (sym W4)
and 1.8% (W3) of the entries, growing block by block, and the free-running
rows part by up to 2.2e-3 of mIoU at 4 scenes. So each is held at the
criteria above with JAX's own quantization handed to the port's tool (JAX's
GPTQ layers, activation scales and FQ qparams in place of the port's; the
rest of the port's pipeline, ``cache_int8`` and FQ's fake-quantized weights
among it, unchanged), and free running (the port's own quantization) within
1e-2 of mIoU, as ``test_torch_fq_cli.py`` holds its free-running click
loops. JAX's click-loop backend closes over FQ's qparams, which XLA folds
into reciprocal products (1.4% of its own embedding, ROADMAP Queue 3); the
JAX tool here encodes the FQ row with the qparams as jit arguments, the form
the port computes and the other FQ tests hold it to.

Then the table's own logic on the port alone: ``--merge`` refuses another
scene style, a kernel-path row outside its base row's CI95 gives
``ci_ok`` false and exit code 1, a base row lacking keys skips the check,
and ``--attn-impl`` picks the encoder's branch.
"""
import contextlib
import importlib.util
import io
import json
import pathlib

import jax
import numpy as np
import pytest

from sam_quantization_tpu.evaluation import click_eval as jce
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.quant import act_scales as jact
from sam_quantization_tpu.quant import artifacts as jart
from sam_quantization_tpu.quant import sequential as jseq
from sam_quantization_tpu.quant.fq import pipeline as jfq
from sam_quantization_tpu_torch.evaluation import click_eval as tce
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.quant import act_scales as tact
from sam_quantization_tpu_torch.quant import artifacts as tart
from sam_quantization_tpu_torch.quant import sequential as tseq
from sam_quantization_tpu_torch.quant.fq import pipeline as tfq
from sam_quantization_tpu_torch.tools import quality_table as tool

REPO = pathlib.Path(__file__).resolve().parents[1]
CKPT = str(REPO / "checkpoints" / "vit_tiny_synth")
NUM_CLICKS, NOC_CLICKS = 3, 4
SETTINGS = ["--ckpt", CKPT, "--eval-samples", "4", "--calib-samples", "2", "--num-clicks",
            str(NUM_CLICKS), "--noc-clicks", str(NOC_CLICKS)]
CONFIGS = ["fp32", "rtn_int4", "rtn_int2u_mixed", "bf16_kernels"]
REQUANTIZED = ["gptq_int4", "gptq_int3", "a8_serving", "fq_int8"]
IOU_TOL = 1e-3
FREE_IOU_TOL = 1e-2
THRESHOLDS = (0.80, 0.85, 0.90)


def _jax_tool():
    spec = importlib.util.spec_from_file_location("tpu_quality_table",
                                                  REPO / "tools" / "quality_table.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(mp, module, name, store):
    """Wrap ``module.name`` to append each result to ``store``."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        store.append(out)
        return out
    mp.setattr(module, name, wrapped)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue()


def _table(main, out, configs, loops_module, patch=None):
    """(the written table, {config: (5-click IoUs, NoC IoUs) per scene}, the
    run's stdout) of one tool's run, with ``patch(mp)`` applied during it."""
    loops = []
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, loops_module, "click_loop_eval", loops)
        if patch:
            patch(mp)
        code, text = _run(main, SETTINGS + ["--out", str(out), "--configs", *configs]
                          + (["--platform", "cpu"] if main is tool.main else []))
    assert code == 0, text
    ious = {c: (np.asarray(loops[2 * i].per_sample_ious),
                np.asarray(loops[2 * i + 1].per_sample_ious)) for i, c in enumerate(configs)}
    return json.loads(out.read_text()), ious, text


def _jax_backend_with_qparams_as_arguments(make):
    """JAX's ``make_sam_backend``, whose encode takes an FQ context's qparams
    as jit arguments instead of closing over them."""
    def backend(model, ctx=None, attn_impl="auto"):
        if not isinstance(ctx, jfq.FQCtx):
            return make(model, ctx=ctx, attn_impl=attn_impl)
        encode = jax.jit(lambda x, q: jsam.encode_image(
            model, x, jfq.FQCtx("quant", ctx.cfg, qparams=q, overrides=ctx.overrides),
            attn_impl=attn_impl))
        return (lambda x: encode(x, ctx.qparams)), make(model, attn_impl=attn_impl)[1]
    return backend


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The JAX table of every configuration, the port's free running, and the
    port's requantized rows on JAX's quantization."""
    tmp = tmp_path_factory.mktemp("quality")
    quant = {"gptq": {}, "scales": [], "fq": []}

    def record_jax(mp):
        mp.setattr(jce, "make_sam_backend",
                   _jax_backend_with_qparams_as_arguments(jce.make_sam_backend))
        gptq = jseq.gptq_quantize_encoder

        def gptq_recorded(enc, ecfg, batches, qcfg, *a, **kw):
            out = gptq(enc, ecfg, batches, qcfg, *a, **kw)
            quant["gptq"][qcfg.bits, qcfg.sym] = out[0]
            return out
        mp.setattr(jseq, "gptq_quantize_encoder", gptq_recorded)
        _recording(mp, jact, "calibrate_act_scales", quant["scales"])
        _recording(mp, jfq, "calibrate_sam", quant["fq"])

    jax_table = _table(_jax_tool().main, tmp / "jax.json", CONFIGS + REQUANTIZED, jce,
                       record_jax)
    port_table = _table(tool.main, tmp / "port.json", CONFIGS + REQUANTIZED, tce)

    def port_encoder(tree):
        d = tmp_path_factory.mktemp("gptq")
        jart.save_quantized(str(d), tree, {"method": "gptq"})
        model = tsam.Sam(tbuild.CONFIGS["vit_tiny"], device="cpu")
        return tbuild.load_jax_encoder(model, tart.load_quantized(str(d))[0]).image_encoder

    encoders = {k: port_encoder(tree) for k, tree in quant["gptq"].items()}
    assert sorted(encoders) == [(3, False), (4, False), (4, True)]
    (scales,) = quant["scales"]
    (qparams,) = quant["fq"]

    def inject(mp):
        mp.setattr(tseq, "gptq_quantize_encoder",
                   lambda enc, batches, qcfg, **kw: (encoders[qcfg.bits, qcfg.sym], {}))
        mp.setattr(tact, "calibrate_act_scales",
                   lambda *a, **kw: {k: float(v) for k, v in scales.items()})
        mp.setattr(tfq, "calibrate_sam", lambda *a, **kw: tfq.qparams_to(
            {k: tuple(np.asarray(v) for v in sz) for k, sz in qparams.items()}, "cpu"))

    injected = _table(tool.main, tmp / "port_on_jax.json", REQUANTIZED, tce, inject)
    return jax_table, port_table, injected


def _first_reach(ious: np.ndarray, thr: float) -> np.ndarray:
    reach = ious >= thr
    return np.where(reach.any(axis=1), reach.argmax(axis=1) + 1, ious.shape[1])


def _assert_rows_match(got, want, got_ious, want_ious):
    """This module's criteria, for one configuration's rows."""
    assert got.keys() == want.keys()
    for k in ("click1_miou", f"click{NUM_CLICKS}_miou"):
        assert abs(got[k] - want[k]) <= IOU_TOL, (k, got[k], want[k])
    for col, key in ((0, "click1_ci95"), (NUM_CLICKS - 1, f"click{NUM_CLICKS}_ci95")):
        gap = float(np.abs(got_ious[0][:, col] - want_ious[0][:, col]).max()) + 1e-4
        np.testing.assert_allclose(got[key], want[key], atol=gap, rtol=0, err_msg=key)
    noc_g, noc_w = got_ious[1], want_ious[1]
    for thr in THRESHOLDS:
        key = f"noc@{int(thr * 100)}"
        apart = _first_reach(noc_g, thr) != _first_reach(noc_w, thr)
        if not apart.any():
            assert got[key] == want[key] and got[f"{key}_ci95"] == want[f"{key}_ci95"], key
            continue
        # a scene whose NoC differs must hold an IoU within 1e-3 of thr
        near = np.abs(np.concatenate([noc_g, noc_w], axis=1) - thr) <= IOU_TOL
        assert near[apart].any(axis=1).all(), (key, noc_g[apart], noc_w[apart])


def _check_tables(got, want):
    assert got.keys() == want.keys() == {"model", "checkpoint_step", "eval_samples", "scenes",
                                         "rows", "ci_ok"}
    assert (got["checkpoint_step"], got["eval_samples"], got["ci_ok"]) == \
        (want["checkpoint_step"], want["eval_samples"], want["ci_ok"])


@pytest.mark.parametrize("config", CONFIGS + REQUANTIZED)
def test_row_matches_jax(tables, config):
    (jt, jious, _), (pt, pious, _), (it, iious, _) = tables
    _check_tables(pt, jt)
    want = jt["rows"][config]
    if config in CONFIGS:
        _assert_rows_match(pt["rows"][config], want, pious[config], jious[config])
        return
    _check_tables(it, jt)
    _assert_rows_match(it["rows"][config], want, iious[config], jious[config])
    got = pt["rows"][config]
    assert got.keys() == want.keys()
    for k in ("click1_miou", f"click{NUM_CLICKS}_miou"):
        assert abs(got[k] - want[k]) <= FREE_IOU_TOL, (k, got[k], want[k])


def test_table_prints_as_jax(tables):
    """The same printed rows in order and the same status line."""
    (_, _, jtext), (_, _, ptext), _ = tables
    every = CONFIGS + REQUANTIZED
    names = [ln.split(" ")[0] for text in (jtext, ptext) for ln in text.splitlines()
             if ln.split(" ")[0] in every]
    assert names == every + every
    status = [json.loads(text.splitlines()[-1]) for text in (jtext, ptext)]
    assert [s["status"] for s in status] == ["ok", "ok"]


# ---------------------------------------------------------------------------
# the table's logic
# ---------------------------------------------------------------------------

SMALL = ["--ckpt", CKPT, "--platform", "cpu", "--eval-samples", "2", "--calib-samples", "1",
         "--num-clicks", "2", "--noc-clicks", "2"]


def _base_file(path, rows, scenes="easy"):
    path.write_text(json.dumps({"model": "vit_tiny", "checkpoint_step": 0, "eval_samples": 2,
                                "scenes": scenes, "rows": rows}))


def test_merge_refuses_another_scene_style(tmp_path):
    out = tmp_path / "q.json"
    _base_file(out, {}, scenes="hard")
    with pytest.raises(SystemExit, match="scenes='hard'"):
        tool.main(SMALL + ["--out", str(out), "--merge", "--configs"])


def test_kernel_row_outside_base_ci_fails(tmp_path):
    """A base row whose CI95s the kernel row cannot reach: the row records
    the failed checks, ``ci_ok`` is false and the exit code 1."""
    out = tmp_path / "q.json"
    far = {"click2_miou": 0.01, "click2_ci95": [0.0, 0.02], "noc@90": 40.0,
           "noc@90_ci95": [39.0, 41.0]}
    _base_file(out, {"fp32": far})
    code, text = _run(tool.main, SMALL + ["--out", str(out), "--merge", "--configs",
                                          "bf16_kernels"])
    assert code == 1
    assert json.loads(text.splitlines()[-1]) == {"status": "ci_fail", "out": str(out)}
    table = json.loads(out.read_text())
    row = table["rows"]["bf16_kernels"]
    assert table["ci_ok"] is False and row["vs_base_row"] == "fp32"
    assert row["within_base_ci95"] == {"click2_miou": False, "noc@90": False}
    assert table["rows"]["fp32"] == far


def test_base_row_lacking_keys_skips_the_check(tmp_path):
    out = tmp_path / "q.json"
    _base_file(out, {"fp32": {"click2_miou": 0.5}})
    code, text = _run(tool.main, SMALL + ["--out", str(out), "--merge", "--configs",
                                          "bf16_kernels"])
    assert code == 0 and "CI check skipped" in text
    table = json.loads(out.read_text())
    assert table["ci_ok"] is True and "within_base_ci95" not in table["rows"]["bf16_kernels"]


def test_attn_impl_maps_to_the_port_branches(tmp_path):
    """``--attn-impl auto`` evaluates through ``attn_impl="kernel"`` and
    records it in the row, as JAX records its own."""
    seen = []
    make = tce.make_sam_backend

    def spy(model, ctx=None, attn_impl="kernel"):
        seen.append(attn_impl)
        return make(model, ctx=ctx, attn_impl=attn_impl)

    out = tmp_path / "q.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tce, "make_sam_backend", spy)
        code, _ = _run(tool.main, SMALL + ["--out", str(out), "--configs", "fp32"])
        assert code == 0
        code, _ = _run(tool.main, SMALL + ["--out", str(out), "--merge", "--attn-impl", "auto",
                                           "--configs", "bf16_kernels"])
    assert code == 0 and seen == ["eager", "kernel"]
    rows = json.loads(out.read_text())["rows"]
    assert "attn_impl" not in rows["fp32"] and rows["bf16_kernels"]["attn_impl"] == "auto"
    assert rows["bf16_kernels"]["vs_base_row"] == "fp32"
