"""Port parity of the BRS refinements on the CPU: ``evaluation/lbfgs.py``
against optax 0.2.6's ``lbfgs()`` step by step, ``InputBRSPredictor`` and
``FeatureBRSPredictor`` against the JAX package's on the committed
``checkpoints/vit_tiny_synth`` weights (float32), and ``cli.evaluate
--mode InputBRS|f-BRS`` end to end.

L-BFGS amplifies rounding, so the optimizer is held two ways. In float64
(JAX's x64 mode) the two run the same algorithm to rounding: every step's
value, step size and parameters within rel 1e-9 over 30 Rosenbrock steps,
the zoom phase and the interval search's step growth included. In float32
(the predictors' dtype) the quadratic's steps agree within 1e-5 (rel.
value, abs. parameters) all the way, Rosenbrock's for the first 12 steps;
later the float32 sum orders of the dot products move the cubic
interpolation's step and the two paths part, as any two float32 runs of a
chaotic iteration would.

BRS maps (opt_steps 2, JAX's step jitted as its predictors run it) within
``BRS_PROB_TOL`` 1e-4, the click-loop tests' ``PROB_TOL``: the decoders'
logits agree to float32 rounding, which the line search's step choice could
amplify (measured 3e-6).
"""

import io
import pathlib
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sam_quantization_tpu.evaluation import predictors as jpred
from sam_quantization_tpu.evaluation.clicker import Clicker as JClicker
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.predictor import SamPredictor as JPredictor
from sam_quantization_tpu_torch.cli import evaluate as tcli
from sam_quantization_tpu_torch.data.synthetic import synthetic_samples
from sam_quantization_tpu_torch.evaluation import lbfgs as tl
from sam_quantization_tpu_torch.evaluation import predictors as tpred
from sam_quantization_tpu_torch.evaluation.clicker import Clicker
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.predictor import SamPredictor as TPredictor
from sam_quantization_tpu_torch.train import checkpoint as tckpt

CKPT = pathlib.Path(__file__).resolve().parents[1] / "checkpoints" / "vit_tiny_synth"
F64_RTOL = 1e-9
F32_TOL = 1e-5
BRS_PROB_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The optimizers and BRS loops run many tiny tensor ops, which more
    torch threads only slow on a CPU shared with other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problems(xp, dtype):
    """{name: (fn(params tuple), init tuple, steps, float32 steps compared)}:
    a convex quadratic over two leaves, Rosenbrock, and a pseudo-Huber
    loss whose first steps grow the step size in the interval search."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(20, 20))
    A = (A @ A.T / 20 + np.eye(20)).astype(dtype)
    b = rng.normal(size=20).astype(dtype)
    A_, b_ = xp.asarray(A), xp.asarray(b)

    def quad(p):
        return 0.5 * p[0] @ (A_ @ p[0]) - b_ @ p[0] + xp.sum((p[1] - 1.0) ** 2)

    def rosen(p):
        x = p[0]
        return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    def huber(p):  # nearly linear far from its minimum at 20
        return xp.sum(xp.sqrt(1.0 + (p[0] - 20.0) ** 2))

    init_q = (rng.normal(size=20).astype(dtype), rng.normal(size=3).astype(dtype))
    return {"quad": (quad, init_q, 12, 12),
            "rosen": (rosen, (np.array([-1.2, 1.0, -0.5, 0.8], dtype),), 30, 12),
            "huber": (huber, (np.zeros(5, dtype),), 12, 12)}


def _optax_steps(fn, init, n):
    """(value, step size, parameters) after each of n jitted optax steps,
    as the JAX package's ``_lbfgs_minimize`` runs them."""
    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(fn)

    @jax.jit
    def step(p, st):
        v, g = vg(p, state=st)
        u, st = opt.update(g, st, p, value=v, grad=g, value_fn=fn)
        return optax.apply_updates(p, u), st, v

    p = tuple(map(jnp.asarray, init))
    st, out = opt.init(p), []
    for _ in range(n):
        p, st, v = step(p, st)
        out.append((float(v), float(optax.tree.get(st, "learning_rate")),
                    [np.asarray(x) for x in p]))
    return out


def _port_steps(fn, init, n):
    opt = tl.LBFGS(fn, tuple(map(torch.from_numpy, init)))
    out = []
    for _ in range(n):
        info = opt.step()
        out.append((info.value, info.stepsize, [t.numpy() for t in opt.params], info))
    return out


@pytest.mark.parametrize("name", ["quad", "rosen", "huber"])
def test_lbfgs_matches_optax_float64(name):
    with jax.enable_x64(True):
        fn, init, n, _ = _problems(jnp, np.float64)[name]
        want = _optax_steps(fn, init, n)
    tfn, tinit, _, _ = _problems(torch, np.float64)[name]
    got = _port_steps(tfn, tinit, n)
    for i, ((gv, gs, gp, _), (wv, ws, wp)) in enumerate(zip(got, want)):
        assert abs(gv - wv) <= F64_RTOL * max(abs(wv), 1.0), (i, gv, wv)
        assert abs(gs - ws) <= F64_RTOL * abs(ws), (i, gs, ws)
        for a, b in zip(gp, wp):
            np.testing.assert_allclose(a, b, rtol=F64_RTOL, atol=F64_RTOL, err_msg=str(i))
    searches = [g[3].linesearch_steps for g in got]
    if name == "rosen":
        assert max(searches) >= 2  # the zoom ran
    if name == "huber":
        assert max(s for _, s, _, _ in got) > 1.0  # the interval search grew the step


@pytest.mark.parametrize("name", ["quad", "rosen", "huber"])
def test_lbfgs_matches_optax_float32(name):
    fn, init, _, n = _problems(jnp, np.float32)[name]
    want = _optax_steps(fn, init, n)
    tfn, tinit, _, _ = _problems(torch, np.float32)[name]
    got = _port_steps(tfn, tinit, n)
    for i, ((gv, gs, gp, _), (wv, ws, wp)) in enumerate(zip(got, want)):
        assert abs(gv - wv) <= F32_TOL * max(abs(wv), 1.0), (i, gv, wv)
        for a, b in zip(gp, wp):
            np.testing.assert_allclose(a, b, rtol=0, atol=F32_TOL, err_msg=str(i))


def test_lbfgs_minimize_stops_at_tol():
    """The JAX loop's early stop: after the first step that starts at a
    value <= tol."""
    seen = []
    tl.lbfgs_minimize(lambda p: torch.sum(p[0] ** 2), (torch.zeros(3),), 10,
                      on_step=seen.append)
    assert len(seen) == 1 and seen[0].value == 0.0


@pytest.fixture(scope="module")
def models():
    """The checkpoint in the port, and the same weights as JAX's ``Sam``
    (``to_jax_params``; JAX's op-by-op init of a template takes seconds)."""
    tmodel = tbuild.sam_model_registry["vit_tiny"](device="cpu")
    tckpt.load_weights(str(CKPT), tmodel, "best")
    trees = [jax.tree_util.tree_map(jnp.asarray, t)
             for t in tbuild.to_jax_params(tmodel.state_dict(), tmodel.config)]
    return jsam.Sam(*trees, config=JCONFIGS["vit_tiny"]), tmodel


@pytest.mark.parametrize("mode", ["InputBRS", "f-BRS"])
def test_brs_predictor_matches_jax(models, mode):
    """Two clicks on a 150 x 200 scene (the second placed on the port's
    first map) through both packages' BRS predictor at opt_steps 2 (one
    JAX prediction: it compiles its step anew for each), the maps within
    BRS_PROB_TOL; the
    port's L-BFGS made both steps from a violated click and no step with
    sufficient decrease raised the loss past the line search's
    approximate-decrease allowance."""
    jmodel, tmodel = models
    cls = "InputBRSPredictor" if mode == "InputBRS" else "FeatureBRSPredictor"
    image, gt = next((img[0, :150], g[:150]) for img, g in synthetic_samples(1, 200, seed=5))
    image = image.astype(np.uint8)
    tp = getattr(tpred, cls)(TPredictor(tmodel), opt_steps=2)
    jp = getattr(jpred, cls)(JPredictor(jmodel), opt_steps=2)
    tp.set_input_image(image)
    jp.set_input_image(image)
    tclick, jclick = Clicker(gt_mask=gt), JClicker(gt_mask=gt)
    pred = np.zeros(gt.shape, bool)
    for _ in range(2):  # the second click corrects the port's first map
        tclick.make_next_click(pred)
        jclick.make_next_click(pred)
        pred = tp.get_prediction(tclick) > 0.5
    got = tp.get_prediction(tclick)
    assert [(c.is_positive, c.coords) for c in tclick.get_clicks()] == \
        [(c.is_positive, c.coords) for c in jclick.get_clicks()]
    want = jp.get_prediction(jclick)
    assert got.shape == want.shape == gt.shape and got.dtype == np.float32
    gap = float(np.abs(got - want).max())
    print(f"{mode}: max |d prob| {gap:.2e}, steps "
          f"{[(round(s.value, 5), round(s.stepsize, 4)) for s in tp.last_steps]}")
    assert gap <= BRS_PROB_TOL, gap
    assert len(tp.last_steps) == 2 and tp.last_steps[0].value > 0.0
    for s in tp.last_steps:
        if s.decrease_error == 0.0:
            assert s.value_after - s.value <= tl.APPROX_DEC_RTOL * abs(s.value)


@pytest.mark.parametrize("mode", ["InputBRS", "f-BRS"])
def test_cli_evaluate_brs_mode(mode):
    """``cli.evaluate vit_tiny --mode InputBRS|f-BRS`` prints the NoC table."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tcli.main(["vit_tiny", "--datasets", "synthetic", "--num-samples", "1",
                        "--n-clicks", "2", "--mode", mode, "--platform", "cpu",
                        "--checkpoint", str(CKPT)])
    out = buf.getvalue()
    assert rc == 0 and "NoC@90%" in out and "synthetic" in out, out
