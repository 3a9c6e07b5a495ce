"""Port parity: the continuous-batching servers (``parallel/serving.py``)
against the JAX package's, on the CPU.

vit_tiny in float32: the port's seed-0 model written as JAX's pytree by
``build_sam.to_jax_params`` and carried back by ``from_jax_params`` (as in
``tests/test_torch_parallel.py``). JAX's ``SamServer`` runs in this process;
the two-rank ``MultiHostSamServer`` runs in one gloo world of two processes
spawned once for the file, which skips where 127.0.0.1 cannot bind.
Tolerances are stated where they are used.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu.parallel.serving import SamServer as JSamServer
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.parallel import serving as tserving

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = TCONFIGS["vit_tiny"]
SIZE = CFG.image_encoder.img_size


def _requests(seed, n):
    """``n`` requests: float images (one smaller than the model's input),
    1 to 3 points with mixed labels."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = (96, 112) if i == 1 else (SIZE, SIZE)
        img = (rng.normal(size=(h, w, 3)) * 20 + 100).astype(np.float32)
        k = 1 + i % 3
        pts = rng.uniform(10, min(h, w) - 10, size=(k, 2)).astype(np.float32)
        out.append((img, pts, np.array([1.0, 0.0, 1.0][:k], np.float32)))
    return out


@pytest.fixture(scope="module")
def models():
    tm = tsam.init(CFG, seed=0, device="cpu")
    trees = tbuild.to_jax_params(tm.state_dict(), CFG)
    jm = jsam.Sam(*[jax.tree_util.tree_map(jnp.asarray, t) for t in trees],
                  config=JCONFIGS["vit_tiny"])
    sd = tbuild.from_jax_params(*trees, CFG)
    return jm, tbuild.load_state_dict(tsam.Sam(CFG, device="cpu"), sd), sd


def _alone(model, req):
    """A request served alone: one B = 1 encode and decode."""
    return [a[0] for a in tserving.run_batch(model, *tserving._pack_requests(
        [tserving._request(*req)], 1, SIZE))]


def _serve(server, reqs):
    server.start()
    futs = [server.submit(*r) for r in reqs]
    results = [f.result(timeout=120) for f in futs]
    server.stop()
    return results


# ---------------------------------------------------------------------------
# SamServer
# ---------------------------------------------------------------------------


def test_pack_requests_matches_jax():
    from sam_quantization_tpu.parallel.serving import SamRequest, _pack_requests

    reqs = _requests(1, 3)
    want = _pack_requests([SamRequest(*r) for r in reqs], 4, SIZE)
    got = tserving._pack_requests([tserving._request(*r) for r in reqs], 4, SIZE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[2][0, 1:] == -1).all() and (got[2][3] == -1).all()  # label -1 pads


def test_server_matches_jax_and_batch_of_one(models, world):
    """``SamServer`` (max_batch 4, 6 requests): each request's low-res logits
    and IoU within atol 1e-4 of JAX's ``SamServer`` (JAX's eager attention
    against the kernels' plain versions, float32), and within 1e-5 of the
    same request served alone (B = 1). (``world`` starts the two-rank world
    here, so that it runs beside JAX's server.)"""
    jm, tm, _ = models
    reqs = _requests(0, 6)
    want = _serve(JSamServer(jm, max_batch=4, max_wait_ms=50), reqs)
    server = tserving.SamServer(tm, max_batch=4, max_wait_ms=50)
    got = _serve(server, reqs)
    assert sum(server.batch_sizes) == 6 and max(server.batch_sizes) <= 4
    for req, (low, iou), (jlow, jiou) in zip(reqs, got, want):
        assert low.shape == (1, SIZE // 4, SIZE // 4) and iou.shape == (1,)
        np.testing.assert_allclose(low, np.asarray(jlow), atol=1e-4, rtol=0)
        np.testing.assert_allclose(iou, np.asarray(jiou), atol=1e-4, rtol=0)
        alone = _alone(tm, req)
        np.testing.assert_allclose(low, alone[0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(iou, alone[1], atol=1e-5, rtol=0)


def test_failing_batch_sets_every_future(models):
    """An exception in a batch (here an image larger than the model's
    input) is set on every future of that batch; the next batch is served."""
    tm = models[1]
    server = tserving.SamServer(tm, max_batch=3, max_wait_ms=1000)
    good = _requests(2, 3)
    bad = (np.zeros((SIZE + 16, SIZE, 3), np.float32), *good[0][1:])
    server.start()
    futs = [server.submit(*r) for r in (good[0], bad, good[1])]
    for f in futs:
        with pytest.raises(ValueError):
            f.result(timeout=60)
    ok = server.submit(*good[2])
    server.stop()
    np.testing.assert_allclose(ok.result(timeout=60)[0], _alone(tm, good[2])[0], atol=1e-5)
    assert server.batch_sizes == [1]


def test_failing_last_batch_before_stop_sets_its_futures(models):
    """A batch that fails while ``stop`` is pending still resolves its
    futures. JAX's dispatcher serves that last batch outside its ``try``
    (``sam_quantization_tpu/parallel/serving.py:160-162``), so its thread
    dies and the future never resolves: not mirrored (ROADMAP Queue 3)."""
    bad = (np.zeros((SIZE + 16, SIZE, 3), np.float32), np.zeros((1, 2), np.float32),
           np.ones(1, np.float32))
    for server, resolved in ((JSamServer(models[0], max_batch=4, max_wait_ms=1000), False),
                             (tserving.SamServer(models[1], max_batch=4, max_wait_ms=1000), True)):
        server.start()
        fut = server.submit(*bad)
        server.stop()
        assert fut.done() == resolved
    assert isinstance(fut.exception(), ValueError)


def test_stop_drains_the_queue(models):
    """Requests queued before ``stop`` are all served."""
    tm = models[1]
    server = tserving.SamServer(tm, max_batch=2, max_wait_ms=50)
    futs = [server.submit(*r) for r in _requests(3, 5)]
    server.start()
    server.stop()
    assert all(f.done() and f.exception() is None for f in futs)
    assert server.batch_sizes == [2, 2, 1]


# ---------------------------------------------------------------------------
# MultiHostSamServer in a two-rank world
# ---------------------------------------------------------------------------

WORKER = r"""
import pickle, sys
import numpy as np
import torch

from sam_quantization_tpu_torch.models import build_sam, sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS
from sam_quantization_tpu_torch.parallel import distributed as D, mesh as M
from sam_quantization_tpu_torch.parallel.serving import MultiHostSamServer

d, rank, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(2)
D.initialize("gloo", device="cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
             rank=rank)
inp = pickle.load(open(f"{d}/inputs.pkl", "rb"))
cfg = CONFIGS["vit_tiny"]
out = {}
for tp, n_req in ((1, (3, 1)), (2, (2, 1))):
    mesh = M.make_mesh(tp=tp)
    model = build_sam.load_state_dict(tsam.Sam(cfg, device="cpu"), inp["sd"])
    if tp > 1:
        M.shard_params(model, mesh)
    srv = MultiHostSamServer(model, mesh, per_host_batch=2)
    reqs = inp["requests"][rank][: n_req[rank]]
    futs = [srv.submit(*r) for r in reqs]
    out[f"served_tp{tp}"] = [srv.tick() for _ in range(3)]
    out[f"results_tp{tp}"] = [f.result(timeout=5) for f in futs]
# At tp 2, rank 0's one request cannot be packed (an image larger than the
# model's input); rank 1's request of the same tick still runs.
good = inp["requests"][rank][2]
size = cfg.image_encoder.img_size
bad = (np.zeros((size + 16, size, 3), np.float32), good[1], good[2])
futs = [srv.submit(*(bad if rank == 0 else good))]
out["served_bad"] = [srv.tick() for _ in range(2)]
out["results_bad"] = [type(f.exception(timeout=5)).__name__ if f.exception(timeout=5)
                      else f.result() for f in futs]
pickle.dump(out, open(f"{d}/out{rank}.pkl", "wb"))
D.destroy()
print(f"rank {rank} OK", flush=True)
"""


@pytest.fixture(scope="module")
def world(models, tmp_path_factory):
    from test_torch_parallel import World

    reqs = [_requests(10, 3), _requests(11, 3)]  # different requests per rank
    return World(WORKER, {"sd": models[2], "requests": reqs},
                 tmp_path_factory.mktemp("serving_world")), reqs


@pytest.mark.parametrize("tp", [1, 2])
def test_multihost_server_ticks(models, world, tp):
    """Two ranks, ``per_host_batch`` 2, uneven queues: the ticks serve every
    request, and the third tick, with nothing pending on either rank, is
    skipped by both. At tp 1 each rank runs its own rows through the kernel
    path; results within 1e-5 of the request served alone. At tp 2 the
    ranks' requests run as one batch through the tp-sharded encoder (eager,
    as JAX's tensor-parallel branch): within 1e-4."""
    tm = models[1]
    out = world[0].results()
    want_served = {1: [[2, 1, 0], [1, 0, 0]], 2: [[2, 0, 0], [1, 0, 0]]}[tp]
    assert [o[f"served_tp{tp}"] for o in out] == want_served
    tol = 1e-5 if tp == 1 else 1e-4
    for rank, o in enumerate(out):
        results = o[f"results_tp{tp}"]
        assert len(results) == sum(want_served[rank])
        for req, (low, iou) in zip(world[1][rank], results):
            alone = _alone(tm, req)
            np.testing.assert_allclose(low, alone[0], atol=tol, rtol=0)
            np.testing.assert_allclose(iou, alone[1], atol=tol, rtol=0)


def test_multihost_server_bad_request_at_tp2(models, world):
    """At tp 2 a request that cannot be packed (an image larger than the
    model's input) on rank 0 fails its future there, before any collective;
    rank 1's request of the same tick runs through the tp-sharded encoder
    (within 1e-4 of it served alone), and the next, empty tick is skipped by
    both: the group neither hangs nor drops the good rows."""
    out = world[0].results()
    assert [o["served_bad"] for o in out] == [[1, 0], [1, 0]]
    assert out[0]["results_bad"] == ["ValueError"]
    low, iou = out[1]["results_bad"][0]
    alone = _alone(models[1], world[1][1][2])
    np.testing.assert_allclose(low, alone[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(iou, alone[1], atol=1e-4, rtol=0)
