"""Port parity: ``tools/train_synthetic.py`` against the JAX package's, on the CPU.

The committed ``checkpoints/vit_tiny_synth`` (its ``latest`` weights and
Adam state), read and written again by the JAX ``save_checkpoint`` into two
directories, is resumed by both tools for two steps (batch 2 from a pool of
4 scenes, 3 training clicks, an eval of 2 held-out scenes x 5 clicks after
the second step, which clears ``--target-iou``).

Not from a JAX-initialised model: from a fresh optax state Adam's first
steps normalise each gradient element (update ~ lr g / |g|), so float32
noise in the elements whose exact gradient is zero (every key bias: a
softmax row is shift-invariant) or near zero moves them by up to 2 lr in
either package: two steps from ``jax.random.PRNGKey(0)``'s vit_tiny read
every key bias and 9 isolated elements of 9 other leaves past the tolerance
below. The carried state keeps every other update proportional to its
gradient. The key biases' elements stay noise-driven from it too (their
moments hold noise; two steps read 46 such elements of 7 key biases past
the tolerance, and none elsewhere), so they are held only to the largest
move of two AdamW steps, 2 lr (1 - b1) / sqrt(1 - b2) + decay.

The training clicks of the two packages draw from different generators, so
both take the first error pixel in raster order (``test_torch_train.py``'s rule). Held: the saved
``latest`` weights' two-step update at the tolerance of
``test_train_step_from_carried_adam_state_matches_jax``, the eval IoUs
(the checkpoints' ``click1`` / ``click5`` extras, the status line's best)
within 1e-3, the status lines, the stored steps and the files written.
"""

import contextlib
import importlib.util
import io
import json
import pathlib

import jax
import numpy as np
import pytest
from test_torch_train import _jax_first_error, _torch_first_error

from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.train import checkpoint as jckpt
from sam_quantization_tpu.train import trainer as jtrainer
from sam_quantization_tpu_torch.tools import train_synthetic as ttool
from sam_quantization_tpu_torch.train import trainer as ttrainer

REPO = pathlib.Path(__file__).resolve().parents[1]
IOU_TOL = 1e-3
CKPT = REPO / "checkpoints" / "vit_tiny_synth"
LR = 3e-4  # the tool's default --lr
# the largest move of one AdamW step at a carried state (b1 0.9, b2 0.999),
# the weight decay's share included
ADAM_STEP = LR * (0.1 / 0.001**0.5 + 1e-4)
START = json.loads((CKPT / "sam_model_latest.json").read_text())["epoch"]
ARGS = ["--resume", "--steps", str(START + 2), "--batch", "2", "--pool", "4",
        "--eval-samples", "2", "--eval-every", "2", "--num-clicks", "3"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("tpu_train_synthetic",
                                                  REPO / "tools" / "train_synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _key_bias(path: str, n: int) -> np.ndarray:
    """The elements of a leaf whose exact gradient is zero: a key bias adds
    q.b_k to every logit of a softmax row, which the softmax ignores."""
    free = np.zeros(n, bool)
    if "k_proj']['b']" in path:
        free[:] = True
    elif path.endswith("['attn']['qkv']['b']"):
        free[n // 3:2 * n // 3] = True
    return free


def _leaves(path: pathlib.Path, prefix: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files if k.startswith(prefix)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both tools resumed from the committed checkpoint as the JAX trainer
    writes it: (its file, {package: (directory, stdout lines)}, the JAX
    leaves' paths)."""
    template = jax.eval_shape(lambda: jsam.init(jax.random.PRNGKey(0), JCONFIGS["vit_tiny"]))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(template)[0]]
    opt_t = jax.eval_shape(jtrainer.make_optimizer(jtrainer.TrainConfig()).init, template)
    model, opt_state, step = jckpt.load_checkpoint(str(CKPT), template, opt_t, "latest")
    assert step == START
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrainer, "_sample_error_click", _jax_first_error)
    mp.setattr(ttrainer, "_sample_error_click", _torch_first_error)
    out = {}
    try:
        for pkg, main, extra in (("jax", _jax_tool().main, []),
                                 ("port", ttool.main, ["--platform", "cpu"])):
            d = tmp_path_factory.mktemp(pkg)
            jckpt.save_checkpoint(str(d), model, opt_state, START, "latest")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(ARGS + ["--out", str(d)] + extra) == 0
            out[pkg] = (d, buf.getvalue().splitlines())
    finally:
        mp.undo()
    return CKPT / "sam_model_latest.npz", out, paths


def test_two_steps_update_the_weights_as_jax(runs):
    """Every leaf of the saved ``latest`` moves from the initial weights as
    the JAX tool's does: |d(update)| <= 1e-3 max|update| plus two float32
    steps of the largest weight, the key biases within two AdamW steps; the
    Adam count goes on by 2 in both."""
    init, out, paths = runs
    old = _leaves(init, "m")
    count = int(_leaves(init, "o")["o0"])
    want = _leaves(out["jax"][0] / "sam_model_latest.npz", "m")
    got = _leaves(out["port"][0] / "sam_model_latest.npz", "m")
    assert sorted(got) == sorted(want) == sorted(old) == sorted(f"m{i}" for i in range(len(paths)))
    moved = 0
    for i, path in enumerate(paths):
        k = f"m{i}"
        upd_w, upd_g = want[k] - old[k], got[k] - old[k]
        moved += bool(np.any(upd_w))
        free = _key_bias(path, upd_w.size).reshape(upd_w.shape)
        assert np.abs(upd_g[free]).max(initial=0.0) <= 2 * ADAM_STEP, path
        ulp = np.spacing(np.abs(old[k]).max()) if old[k].size else 0.0
        np.testing.assert_allclose(upd_g[~free], upd_w[~free],
                                   atol=1e-3 * np.abs(upd_w).max(initial=0.0) + 2 * ulp, rtol=0,
                                   err_msg=path)
    assert moved > 0.8 * len(old), moved
    for pkg in out:
        assert int(_leaves(out[pkg][0] / "sam_model_latest.npz", "o")["o0"]) == count + 2


def test_eval_status_lines_and_checkpoints_match_jax(runs):
    """The same lines in order (``resumed at step N``, the step-N loss line,
    ``eval@N+2``, the status), the eval IoUs within 1e-3, ``latest`` and
    ``best`` written with step N + 2 and the same extras."""
    _, out, _ = runs
    lines = {pkg: out[pkg][1] for pkg in out}
    for pkg in lines:
        assert lines[pkg][0] == f"resumed at step {START}"
        assert lines[pkg][1].startswith(f"step {START}: loss=")
        assert lines[pkg][2].startswith(f"eval@{START + 2}: click1=")
        assert len(lines[pkg]) == 4
    status = {pkg: json.loads(lines[pkg][-1]) for pkg in lines}
    assert status["port"].keys() == status["jax"].keys()
    assert status["port"]["status"] == status["jax"]["status"]
    assert status["jax"] == {**status["jax"], "status": "target_reached", "step": START + 2}
    assert status["port"]["step"] == START + 2
    assert status["port"]["click5"] == pytest.approx(status["jax"]["click5"], abs=IOU_TOL)
    for name in ("latest", "best"):
        meta = {pkg: json.loads((out[pkg][0] / f"sam_model_{name}.json").read_text())
                for pkg in out}
        assert meta["port"].keys() == meta["jax"].keys() == {"epoch", "click1", "click5"}
        assert meta["port"]["epoch"] == meta["jax"]["epoch"] == START + 2
        for k in ("click1", "click5"):
            assert meta["port"][k] == pytest.approx(meta["jax"][k], abs=IOU_TOL), (name, k)
    assert sorted(p.name for p in out["port"][0].iterdir()) == \
        sorted(p.name for p in out["jax"][0].iterdir())
