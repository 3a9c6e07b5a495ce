"""The port's decoder export (``export_js.py``) and demo server
(``demo_server.py``) on the CPU.

The manifest and float32 blob must be byte-identical to the JAX package's
``export_js`` for the same weights. The server is booted as a subprocess
(``--platform cpu``, vit_tiny from an upstream-named ``.pth``) and put
through ``tests/test_demo_server.py``'s HTTP test: ``demo/decoder_ref.py``
(the numpy spec of ``decoder.js``) on the served blob and embedding matches
the server's ``/click`` IoU within 1e-3 and its mask up to the single- vs
double-bilinear upsample; and each ``/click`` mask is byte-equal to the port
predictor's ``predict`` on the same weights, image and clicks. Both
packages' servers with ``--load`` of one ``--sym --act-scales`` artifact and
``--serve-int8``: the same masks, byte for byte, and ``/embedding`` within
rel L2 1e-5.
"""

import base64
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from sam_quantization_tpu import export_js as jexport
from sam_quantization_tpu.models import sam as jsam
from sam_quantization_tpu.models.configs import CONFIGS as JCONFIGS
from sam_quantization_tpu_torch import export_js as texport
from sam_quantization_tpu_torch.models import build_sam as tbuild
from sam_quantization_tpu_torch.models import sam as tsam
from sam_quantization_tpu_torch.models.configs import CONFIGS as TCONFIGS
from sam_quantization_tpu_torch.predictor import SamPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "demo"))
H, W = 120, 160


def _port_model(jm):
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    sd = tbuild.from_jax_params(to_np(jm.image_encoder), to_np(jm.prompt_encoder),
                                to_np(jm.mask_decoder), TCONFIGS["vit_tiny"])
    return tbuild.load_state_dict(tsam.Sam(TCONFIGS["vit_tiny"], device="cpu"), sd)


@pytest.mark.parametrize("key", [0, 3])
def test_flatten_decoder_is_byte_identical_to_jax(key):
    jm = jsam.init(jax.random.PRNGKey(key), JCONFIGS["vit_tiny"])
    want_manifest, want_blob = jexport.flatten_decoder(jm)
    manifest, blob = texport.flatten_decoder(_port_model(jm))
    assert manifest == want_manifest
    assert blob == want_blob
    assert manifest["total_floats"] * 4 == len(blob)


def test_export_decoder_js_files_match_jax(tmp_path):
    jm = jsam.init(jax.random.PRNGKey(1), JCONFIGS["vit_tiny"])
    jexport.export_decoder_js(jm, str(tmp_path / "jax"))
    texport.export_decoder_js(_port_model(jm), str(tmp_path / "port"))
    for name in ("decoder_manifest.json", "decoder_weights.bin"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """The weights of JAX's server test (vit_tiny, PRNGKey(0)) as a .pth."""
    path = tmp_path_factory.mktemp("demo") / "vit_tiny.pth"
    torch.save(_port_model(jsam.init(jax.random.PRNGKey(0), JCONFIGS["vit_tiny"])).state_dict(),
               path)
    return path


@contextlib.contextmanager
def _serving(*argv):
    """A demo server run as ``python *argv --port P`` from the repo root,
    until its decoder manifest answers; yields its URL."""
    port = _free_port()
    proc = subprocess.Popen([sys.executable, *argv, "--port", str(port)], cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    url = f"http://127.0.0.1:{port}"
    try:
        for _ in range(240):
            try:
                urllib.request.urlopen(url + "/decoder_manifest.json", timeout=5)
                break
            except Exception:
                if proc.poll() is not None:
                    raise RuntimeError("demo server died on startup")
                time.sleep(0.5)
        else:
            raise RuntimeError("demo server never came up")
        yield url
    finally:
        proc.terminate()
        proc.wait(timeout=10)


@pytest.fixture(scope="module")
def server(pth):
    with _serving("-m", "sam_quantization_tpu_torch.demo_server", "--model", "vit_tiny",
                  "--checkpoint", str(pth), "--platform", "cpu") as url:
        yield url


def _get(url, p):
    return urllib.request.urlopen(url + p, timeout=300).read()


def _post(url, p, obj):
    req = urllib.request.Request(url + p, json.dumps(obj).encode())
    return json.loads(urllib.request.urlopen(req, timeout=600).read())


def _scene():
    img = np.zeros((H, W, 4), np.uint8)
    img[..., 3] = 255
    yy, xx = np.mgrid[:H, :W]
    img[((yy - 60) ** 2 + (xx - 80) ** 2) < 900, :3] = [230, 150, 20]
    img[10:40, 10:40, :3] = [100, 170, 250]
    return img


def test_static_routes_and_errors(server):
    assert _get(server, "/") == open(os.path.join(ROOT, "demo", "index.html"), "rb").read()
    assert _get(server, "/decoder.js") == open(os.path.join(ROOT, "demo", "decoder.js"),
                                               "rb").read()
    for path, code in (("/embedding", 400), ("/nothing", 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server, path)
        assert e.value.code == code
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/set_image", {"height": 2})
    assert e.value.code == 400


def test_served_decoder_blob_is_the_models(server, pth):
    model = tbuild.sam_model_registry["vit_tiny"](checkpoint=str(pth), device="cpu")
    manifest, blob = texport.flatten_decoder(model)
    assert json.loads(_get(server, "/decoder_manifest.json")) == manifest
    assert _get(server, "/decoder_weights.bin") == blob


def test_browser_decode_parity_over_http(server, pth):
    """tests/test_demo_server.py's test against the port's server, with each
    /click mask byte-equal to the port predictor's predict."""
    from decoder_ref import DecoderRef

    img = _scene()
    r = _post(server, "/set_image", {"rgba": base64.b64encode(img.tobytes()).decode(),
                                     "height": H, "width": W})
    assert r["ok"]
    predictor = SamPredictor(
        tbuild.sam_model_registry["vit_tiny"](checkpoint=str(pth), device="cpu"))
    predictor.set_image(img[..., :3].copy())

    emb_r = json.loads(_get(server, "/embedding"))
    manifest = json.loads(_get(server, "/decoder_manifest.json"))
    blob = _get(server, "/decoder_weights.bin")
    assert manifest["total_floats"] * 4 == len(blob)
    ref = DecoderRef(manifest, blob)
    emb = np.frombuffer(base64.b64decode(emb_r["embedding"]), np.float32)
    np.testing.assert_array_equal(emb.reshape(emb_r["shape"]), predictor.features.numpy())
    eh, ew, C = emb_r["shape"][1:]
    emb = emb.reshape(eh * ew, C)
    ih, iw = emb_r["input_size"]
    oh, ow = emb_r["original_size"]
    assert (oh, ow) == (H, W)

    js_clicks, clicks = [], []
    for click in [(80.0, 60.0, 1), (25.0, 25.0, 0), (120.0, 90.0, 1)]:
        js_clicks.append((click[0] * iw / ow, click[1] * ih / oh, click[2]))
        clicks.append(click)
        low, iou_js = ref.decode(emb, js_clicks)
        srv = _post(server, "/click", {"x": click[0], "y": click[1], "label": click[2]})
        sm = np.frombuffer(base64.b64decode(srv["mask"]), np.uint8).reshape(
            srv["height"], srv["width"])
        masks, ious, _ = predictor.predict(
            np.array([c[:2] for c in clicks], np.float32),
            np.array([c[2] for c in clicks], np.float32), multimask_output=False)
        assert sm.tobytes() == masks[0].astype(np.uint8).tobytes()
        assert srv["iou"] == float(ious[0])
        # identical decoder math -> identical predicted IoU
        np.testing.assert_allclose(iou_js, srv["iou"], atol=1e-3)
        # masks agree up to the single- vs double-bilinear upsample
        # (index.html lowResToMask replicated here)
        S4 = low.shape[0]
        img_size = manifest["config"]["img_size"]
        sx, sy = iw * S4 / img_size / ow, ih * S4 / img_size / oh
        ys = np.clip((np.arange(oh) + 0.5) * sy - 0.5, 0, S4 - 1)
        xs = np.clip((np.arange(ow) + 0.5) * sx - 0.5, 0, S4 - 1)
        y0 = ys.astype(int)
        y1 = np.minimum(y0 + 1, S4 - 1)
        wy = (ys - y0)[:, None]
        x0 = xs.astype(int)
        x1 = np.minimum(x0 + 1, S4 - 1)
        wx = (xs - x0)[None, :]
        v = ((1 - wy) * ((1 - wx) * low[np.ix_(y0, x0)] + wx * low[np.ix_(y0, x1)])
             + wy * ((1 - wx) * low[np.ix_(y1, x0)] + wx * low[np.ix_(y1, x1)]))
        jm = (v > 0).astype(np.uint8)
        inter = int((jm & sm).sum())
        union = int((jm | sm).sum())
        assert union == 0 or inter / union > 0.95, inter / union

    assert _post(server, "/reset", {})["ok"]
    srv = _post(server, "/click", {"x": 80.0, "y": 60.0, "label": 1})
    masks, ious, _ = predictor.predict(np.array([[80.0, 60.0]], np.float32),
                                       np.array([1.0], np.float32), multimask_output=False)
    assert srv["iou"] == float(ious[0])


def test_int8_servers_match_jax(pth, tmp_path):
    """The port's server and JAX's ``demo/server.py``, each with ``--load``
    of the port's ``cli.quantize --sym --act-scales`` artifact (W4 g32) and
    ``--serve-int8``, on one image and three clicks."""
    from sam_quantization_tpu_torch.cli import quantize as tquantize

    art = str(tmp_path / "sym")
    with contextlib.redirect_stdout(io.StringIO()):
        assert tquantize.main(["vit_tiny", "--checkpoint", str(pth), "--platform", "cpu",
                               "--nsamples", "2", "--wbits", "4", "--groupsize", "32", "--sym",
                               "--act-scales", "--save", art]) == 0
    flags = ["--model", "vit_tiny", "--checkpoint", str(pth), "--load", art, "--serve-int8"]
    img = _scene()
    body = {"rgba": base64.b64encode(img.tobytes()).decode(), "height": H, "width": W}
    replies = []
    with _serving("-m", "sam_quantization_tpu_torch.demo_server", *flags, "--platform", "cpu") as port, \
            _serving(os.path.join("demo", "server.py"), *flags, "--cpu") as jax_url:
        for url in (port, jax_url):
            assert _post(url, "/set_image", body)["ok"]
            emb = json.loads(_get(url, "/embedding"))
            clicks = [_post(url, "/click", {"x": x, "y": y, "label": lab})
                      for x, y, lab in [(80.0, 60.0, 1), (25.0, 25.0, 0), (120.0, 90.0, 1)]]
            replies.append((emb, clicks))
    (emb_t, clicks_t), (emb_j, clicks_j) = replies
    assert emb_t["shape"] == emb_j["shape"]
    et, ej = (np.frombuffer(base64.b64decode(e["embedding"]), np.float32) for e in (emb_t, emb_j))
    assert np.linalg.norm(et - ej) / np.linalg.norm(ej) <= 1e-5
    for ct, cj in zip(clicks_t, clicks_j):
        assert (ct["height"], ct["width"]) == (cj["height"], cj["width"]) == (H, W)
        assert ct["mask"] == cj["mask"]
