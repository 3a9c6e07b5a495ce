"""Interactive SAM demo server.

Counterpart of ``demo/server.py`` with the same routes and bodies: the page
(``demo/index.html``, ``demo/decoder.js``, read from the repository's
``demo/`` directory) sends an RGBA image and clicks; the server encodes the
image once with :class:`SamPredictor` and answers each click with the mask
as raw bytes. ``GET /embedding`` and the decoder's manifest and weight blob
(``export_js.flatten_decoder``) let the browser decode clicks itself::

    python -m sam_quantization_tpu_torch.demo_server --model vit_b [--checkpoint sam.pth]
        [--load DIR [--serve-int8]] [--port 8000] [--platform cpu]

Routes: ``GET /``, ``/decoder.js``, ``/decoder_manifest.json``,
``/decoder_weights.bin``, ``/embedding`` (the cached features as float32,
base64, with the input and original sizes); ``POST /set_image`` ({rgba
base64, height, width}), ``/click`` ({x, y, label}: the mask of every click
since ``set_image``), ``/reset``. The model runs on the CUDA card unless
``--platform cpu`` is given. Requests are answered one at a time.
"""

from __future__ import annotations

import argparse
import base64
import json
import pathlib
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

DEMO_DIR = pathlib.Path(__file__).resolve().parents[1] / "demo"
STATIC = {"/": ("index.html", "text/html"), "/index.html": ("index.html", "text/html"),
          "/decoder.js": ("decoder.js", "application/javascript")}


def make_server(predictor, manifest: dict, blob: bytes, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
    """An HTTP server of the demo's routes around ``predictor``; call
    ``serve_forever`` (from a thread to serve in-process) and ``shutdown``."""
    state = {"clicks": []}
    lock = threading.Lock()  # one predictor, one request at a time
    manifest_body = json.dumps(manifest).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path in STATIC:
                name, ctype = STATIC[path]
                self._send(200, (DEMO_DIR / name).read_bytes(), ctype)
            elif path == "/decoder_manifest.json":
                self._send(200, manifest_body)
            elif path == "/decoder_weights.bin":
                self._send(200, blob, "application/octet-stream")
            elif path == "/embedding":
                with lock:
                    if predictor.features is None:
                        self._send(400, b'{"error": "no image set"}')
                        return
                    emb = predictor.features.float().cpu().numpy()  # (1, h, w, C)
                    body = json.dumps({
                        "embedding": base64.b64encode(np.ascontiguousarray(emb).tobytes()).decode(),
                        "shape": list(emb.shape),
                        "input_size": list(predictor.input_size),
                        "original_size": list(predictor.original_size),
                    }).encode()
                self._send(200, body)
            else:
                self._send(404, b"{}")

        def do_POST(self):
            try:
                with lock:
                    self._do_post()
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, json.dumps({"error": f"bad request: {e!r}"}).encode())

        def _do_post(self):
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n))
            if self.path == "/set_image":
                h, w = payload["height"], payload["width"]
                rgba = np.frombuffer(base64.b64decode(payload["rgba"]), np.uint8).reshape(h, w, 4)
                predictor.set_image(rgba[..., :3].copy())
                state["clicks"] = []
                self._send(200, b'{"ok": true}')
            elif self.path == "/click":
                state["clicks"].append(
                    (float(payload["x"]), float(payload["y"]), int(payload["label"])))
                clicks = state["clicks"]
                coords = np.array([[c[0], c[1]] for c in clicks], np.float32)
                labels = np.array([c[2] for c in clicks], np.float32)
                masks, ious, _ = predictor.predict(point_coords=coords, point_labels=labels,
                                                   multimask_output=False)
                mask = np.ascontiguousarray(masks[0].astype(np.uint8))
                self._send(200, json.dumps({
                    "mask": base64.b64encode(mask.tobytes()).decode(),
                    "iou": float(ious[0]),
                    "height": mask.shape[0],
                    "width": mask.shape[1],
                }).encode())
            elif self.path == "/reset":
                state["clicks"] = []
                self._send(200, b'{"ok": true}')
            else:
                self._send(404, b"{}")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    from sam_quantization_tpu_torch.cli import add_model_args, add_platform_arg, build_model, device_of

    ap = argparse.ArgumentParser("samq-demo-server")
    ap.add_argument("--model", default="vit_b", choices=["vit_b", "vit_l", "vit_h", "vit_tiny"])
    add_model_args(ap)
    ap.add_argument("--serve-int8", action="store_true",
                    help="cached-int8 + static-act serving mode (needs a --sym --act-scales "
                         "artifact)")
    ap.add_argument("--port", type=int, default=8000)
    add_platform_arg(ap)
    args = ap.parse_args(argv)

    from sam_quantization_tpu_torch.export_js import flatten_decoder
    from sam_quantization_tpu_torch.nn.packed import cache_int8, default_serve_skip
    from sam_quantization_tpu_torch.predictor import SamPredictor

    model, qcfg = build_model(args, device_of(args))
    if args.load and args.serve_int8 and qcfg.get("sym"):
        cache_int8(model.image_encoder, act_scales=qcfg.get("act_scales"),
                   skip=default_serve_skip(model.config.image_encoder.embed_dim))
    manifest, blob = flatten_decoder(model)
    server = make_server(SamPredictor(model), manifest, blob, "0.0.0.0", args.port)
    print(f"demo at http://localhost:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
