"""Port parity: the FQ override search (``tools/fq_tune.py``) against the JAX
package's, on the CPU, on ``checkpoints/vit_tiny_synth``.

Both tools' ``main`` run ``--configs base diag8`` at 4 scenes, 2 calibration
scenes and NoC to 4. JAX's click-loop backend and its SNR diagnosis close
over FQ's qparams, which XLA folds into reciprocal products (ROADMAP Queue 3;
it moves single SNR points by up to 3 dB,
``tests/test_torch_fq_sam.py``): as ``tests/test_torch_quality_table.py``
holds ``fq_int8``, the JAX tool here encodes, and diagnoses, with the qparams
as jit arguments (``fq_pointwise_snr`` transcribed below), and the port's
tool is given
JAX's qparams, call for call (``base``, then ``diag8``'s first and second
calibration); the rest of its pipeline (fake-quantized weights, the SNR
diagnosis, the click loops) is its own. Its rows must then equal JAX's:
click-k mIoU within 1e-3 (JAX rounds each to 4 places; the two packages'
per-scene IoUs differ by float32 rounding) and NoC equal unless a scene's
NoC differs where one of its IoUs lies within 1e-3 of the threshold. Free
running (the port's own calibration, whose float32 sums run in another
order), its rows lie within 1e-2 of mIoU, as the other FQ tests hold their
free-running click loops.

The worst-8 SNR points that ``diag8`` overrides must be JAX's list, in JAX's
order; two points whose SNRs lie within ``SNR_TIE`` dB may swap, and the
check names them. ``--snr-report`` on JAX's qparams must list JAX's points
in the same order and to the printed 0.01 dB, under the same rule; at 2
calibration scenes JAX's ``--snr-report`` computes exactly the SNR call of
its ``diag8`` (fq_tune.py:129-133 against :73), which is recorded here.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sam_quantization_tpu.evaluation import click_eval as jce
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.quant.fq import pipeline as jfq
from sam_quantization_tpu_torch.evaluation import click_eval as tce
from sam_quantization_tpu_torch.quant.fq import pipeline as tfq
from sam_quantization_tpu_torch.tools import fq_tune as tool

REPO = pathlib.Path(__file__).resolve().parents[1]
CKPT = str(REPO / "checkpoints" / "vit_tiny_synth")
NOC_CLICKS = 4
SETTINGS = ["--ckpt", CKPT, "--eval-samples", "4", "--calib-samples", "2", "--noc-clicks",
            str(NOC_CLICKS)]
CONFIGS = ["base", "diag8"]
IOU_TOL, FREE_IOU_TOL = 1e-3, 1e-2
SNR_TIE = 0.05  # dB: the two packages' float32 sums of |x|^2 and |x - q(x)|^2
# above this an error sum is float32 rounding of near-exact quantization
# (float32's epsilon is -144 dB): its SNR is noise, held only to be there
NOISE_DB = 100.0


def _jax_tool():
    spec = importlib.util.spec_from_file_location("tpu_fq_tune", REPO / "tools" / "fq_tune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(mp, module, name, store):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        store.append(out)
        return out
    mp.setattr(module, name, wrapped)


def _run(main, argv, patch):
    """(stdout, the click loops' per-scene IoUs) of one tool run under
    ``patch(mp)``."""
    loops, buf = [], io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, jce if main is not tool.main else tce, "click_loop_eval", loops)
        patch(mp)
        with contextlib.redirect_stdout(buf):
            main(argv)
    return buf.getvalue(), [np.asarray(r.per_sample_ious) for r in loops]


def _jax_backend_with_qparams_as_arguments(make):
    def backend(model, ctx=None, attn_impl="auto"):
        if not isinstance(ctx, jfq.FQCtx):
            return make(model, ctx=ctx, attn_impl=attn_impl)
        encode = jax.jit(lambda x, q: jsam.encode_image(
            model, x, jfq.FQCtx("quant", ctx.cfg, qparams=q, overrides=ctx.overrides),
            attn_impl=attn_impl))
        return (lambda x: encode(x, ctx.qparams)), make(model, attn_impl=attn_impl)[1]
    return backend


def _jax_snr_with_qparams_as_arguments(model, samples, fqcfg, qparams, max_points=24):
    """JAX's ``fq_pointwise_snr`` (quant/fq/pipeline.py:338-399), its jitted
    forward taking the qparams as arguments instead of closing over them."""
    from sam_quantization_tpu.models import sam as sam_lib

    class SnrCtx(jfq.FQCtx):
        def __init__(self, q):
            super().__init__("quant", fqcfg, qparams=q)
            self.err, self.pw = {}, {}

        def act(self, path, x, ln_input=False):
            y = super().act(path, x, ln_input=ln_input)
            xf, yf = x.astype(jnp.float32), y.astype(jnp.float32)
            self.err[path] = self.err.get(path, 0.0) + jnp.sum((xf - yf) ** 2)
            self.pw[path] = self.pw.get(path, 0.0) + jnp.sum(xf**2)
            return y

    @jax.jit
    def run(model, q, x, coords, labels):
        ctx = SnrCtx(q)
        emb = sam_lib.encode_image(model, sam_lib.preprocess(model, x), ctx, attn_impl="xla")
        h, w = model.config.prompt_encoder.image_embedding_size
        zero_mask = jnp.zeros((x.shape[0], 4 * h, 4 * w, 1), jnp.float32)
        sam_lib.decode_masks(model, emb, points=(coords, labels), mask_inputs=zero_mask,
                             multimask_output=False, ctx=ctx)
        return ctx.err, ctx.pw

    err, pw = {}, {}
    for img, gt in samples:
        ys, xs = np.nonzero(gt)
        cy, cx = (int(ys.mean()), int(xs.mean())) if len(ys) else (0, 0)
        coords = np.zeros((1, max_points, 2), np.float32)
        labels = -np.ones((1, max_points), np.float32)
        coords[0, 0] = (cx, cy)
        labels[0, 0] = 1.0
        e, p = run(model, qparams, jnp.asarray(img), jnp.asarray(coords), jnp.asarray(labels))
        for k in e:
            err[k] = err.get(k, 0.0) + float(e[k])
            pw[k] = pw.get(k, 0.0) + float(p[k])
    snr = {k: 10.0 * np.log10(max(pw[k], 1e-30) / max(err[k], 1e-30)) for k in err}
    return dict(sorted(snr.items(), key=lambda kv: kv[1]))


def _given(qparams):
    """A ``calibrate_sam`` that returns JAX's qparams, call by call."""
    todo = list(qparams)

    def calibrate_sam(*args, **kwargs):
        q = todo.pop(0)
        return tfq.qparams_to({k: tuple(np.asarray(v) for v in sz) for k, sz in q.items()},
                              "cpu")
    return calibrate_sam


@pytest.fixture(scope="module")
def runs():
    rec = {"qparams": [], "snr": [], "port_snr": []}

    def jax_patch(mp):
        mp.setattr(jce, "make_sam_backend",
                   _jax_backend_with_qparams_as_arguments(jce.make_sam_backend))
        _recording(mp, jfq, "calibrate_sam", rec["qparams"])
        mp.setattr(jfq, "fq_pointwise_snr", _jax_snr_with_qparams_as_arguments)
        _recording(mp, jfq, "fq_pointwise_snr", rec["snr"])

    def injected(mp):
        mp.setattr(tfq, "calibrate_sam", _given(rec["qparams"]))
        _recording(mp, tfq, "fq_pointwise_snr", rec["port_snr"])

    argv = SETTINGS + ["--configs", *CONFIGS]
    out = {"jax": _run(_jax_tool().main, argv, jax_patch)}
    assert len(rec["qparams"]) == 3 and len(rec["snr"]) == 1
    port_argv = argv + ["--platform", "cpu"]
    out["free"] = _run(tool.main, port_argv, lambda mp: None)
    out["injected"] = _run(tool.main, port_argv, injected)
    out["report"] = _run(tool.main, SETTINGS + ["--snr-report", "--platform", "cpu"],
                         lambda mp: mp.setattr(tfq, "calibrate_sam", _given(rec["qparams"][:1])))
    return out, rec


def _rows(text):
    return json.loads(text.splitlines()[-1])


def _first_reach(ious, thr):
    reach = ious >= thr
    return np.where(reach.any(axis=1), reach.argmax(axis=1) + 1, ious.shape[1])


def _assert_same_order(got, want, what):
    """``got`` and ``want`` are [(point, dB)]: the same points; below
    NOISE_DB the same SNRs to SNR_TIE and in the same order, but for
    neighbours of ``want`` within SNR_TIE dB, which may swap."""
    assert sorted(p for p, _ in got) == sorted(p for p, _ in want), what
    db = dict(want)
    for i, ((g, gdb), (w, _)) in enumerate(zip(got, want)):
        if db[w] > NOISE_DB:
            break
        assert abs(gdb - db[g]) <= SNR_TIE, (what, g, gdb, db[g])
        if g != w:
            assert abs(db[g] - db[w]) <= SNR_TIE, (what, i, g, w, db[g], db[w])


@pytest.mark.parametrize("config", CONFIGS)
def test_row_matches_jax(runs, config):
    (jtext, jloops), (ftext, _), (itext, iloops), _ = runs[0].values()
    i = CONFIGS.index(config)
    want, got, free = (_rows(t)[config] for t in (jtext, itext, ftext))
    assert got.keys() == want.keys() == free.keys() == {"click1", "click5", "noc@85", "noc@90"}
    for k in ("click1", "click5"):
        assert abs(got[k] - want[k]) <= IOU_TOL, (k, got[k], want[k])
        assert abs(free[k] - want[k]) <= FREE_IOU_TOL, (k, free[k], want[k])
    g5, w5 = iloops[2 * i], jloops[2 * i]
    assert abs(g5 - w5).max() <= IOU_TOL
    g_noc, w_noc = iloops[2 * i + 1], jloops[2 * i + 1]
    for thr in (0.85, 0.90):
        key = f"noc@{int(thr * 100)}"
        apart = _first_reach(g_noc, thr) != _first_reach(w_noc, thr)
        if not apart.any():
            assert got[key] == want[key], key
            continue
        near = np.abs(np.concatenate([g_noc, w_noc], axis=1) - thr) <= IOU_TOL
        assert near[apart].any(axis=1).all(), (key, g_noc[apart], w_noc[apart])


def test_worst_points_match_jax(runs):
    """diag8's worst-8 list on JAX's qparams, and the SNRs behind it."""
    _, rec = runs
    (want,), (got,) = rec["snr"], rec["port_snr"]
    want, got = list(want.items()), list(got.items())
    _assert_same_order(got, want, "every point")  # names a tie that reorders them
    assert sorted(p for p, _ in got[:8]) == sorted(p for p, _ in want[:8])  # the overrides
    jtext, itext = runs[0]["jax"][0], runs[0]["injected"][0]
    lines = [next(ln for ln in t.splitlines() if "worst-8 SNR points" in ln)
             for t in (jtext, itext)]
    names = [re.findall(r"\('([^']+)'", ln) for ln in lines]
    assert names[0] == [p for p, _ in want[:8]] and names[1] == [p for p, _ in got[:8]]


def test_snr_report_lists_jax_points(runs):
    """``--snr-report`` prints every point, worst first, in JAX's order."""
    (report, _), (want,) = runs[0]["report"], runs[1]["snr"]
    printed = [(ln.split()[2], float(ln.split()[0])) for ln in report.splitlines()]
    assert all(ln.split()[1] == "dB" for ln in report.splitlines())
    _assert_same_order(printed, list(want.items()), "snr-report")


def test_prints_as_jax(runs):
    """The same row lines in order, each the printed dict of the JSON's row."""
    for key in ("jax", "free", "injected"):
        text = runs[0][key][0]
        names = [ln.split(" ")[0] for ln in text.splitlines() if ln.split(" ")[0] in CONFIGS]
        assert names == CONFIGS, key
        assert list(_rows(text)) == CONFIGS
