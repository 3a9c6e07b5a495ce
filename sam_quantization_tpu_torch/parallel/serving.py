"""Continuous image batching for the encoder -> decoder serving pipeline.

Counterpart of ``sam_quantization_tpu/parallel/serving.py`` (SURVEY §7's
serving target; the reference has no serving layer):

* requests (image + prompts) land in a host-side queue;
* a dispatcher thread drains up to ``max_batch`` requests per tick and runs
  ONE encode over the batch's images, through the kernels, and ONE decode
  over its prompts;
* results resolve per-request futures.

The port compiles no program per shape, so a batch holds only its real
rows: JAX pads every batch to ``max_batch`` for its jitted program.

Two servers:

* :class:`SamServer`: one process, one card, one dispatcher thread.
* :class:`MultiHostSamServer`: one process per card on a dp x tp mesh,
  driven in lockstep ticks. JAX's ``SamServer(mesh=...)``, which splits a
  batch over the local devices of one process, maps here: torch runs one
  process per card.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from sam_quantization_tpu_torch.models import sam as sam_lib
from sam_quantization_tpu_torch.parallel import distributed, mesh as mesh_lib
from sam_quantization_tpu_torch.predictor import MAX_POINTS


@dataclasses.dataclass
class SamRequest:
    image: np.ndarray  # (S, S, 3) raw image at the model's input size (or smaller)
    point_coords: np.ndarray  # (N, 2) xy in the model frame
    point_labels: np.ndarray  # (N,)
    future: Future = dataclasses.field(default_factory=Future)


def _pack_requests(requests: List[SamRequest], batch: int, size: int):
    """Pad a request list into (images, coords, labels) arrays of ``batch``
    rows. Images are zero-padded to ``size`` before normalisation, as in
    JAX; unused point slots carry label -1 (the prompt encoder's pad code)."""
    images = np.zeros((batch, size, size, 3), np.float32)
    coords = np.zeros((batch, MAX_POINTS, 2), np.float32)
    labels = -np.ones((batch, MAX_POINTS), np.float32)
    for i, r in enumerate(requests):
        h, w = r.image.shape[:2]
        images[i, :h, :w] = r.image
        k = min(len(r.point_coords), MAX_POINTS)
        coords[i, :k] = r.point_coords[:k]
        labels[i, :k] = r.point_labels[:k]
    return images, coords, labels


def _request(image, point_coords, point_labels) -> SamRequest:
    return SamRequest(image=np.asarray(image),
                      point_coords=np.asarray(point_coords, np.float32),
                      point_labels=np.asarray(point_labels, np.float32))


def run_batch(model: sam_lib.Sam, images: np.ndarray, coords: np.ndarray, labels: np.ndarray,
              multimask_output: bool = False):
    """One encode and one decode over a packed batch: ``sam.encode_image(
    sam.preprocess(...))`` in the encoder's weight dtype, the decoder in
    float32. Returns (low-res logits (B, N, 4h, 4w), IoU (B, N)) as numpy."""
    dev = model.device
    dtype = model.image_encoder.patch_embed.proj.weight.dtype
    x = sam_lib.preprocess(model, torch.from_numpy(images).to(dev)).to(dtype)
    emb = sam_lib.encode_image(model, x)
    low_res, iou = sam_lib.decode_masks(
        model, emb.float(),
        points=(torch.from_numpy(coords).to(dev), torch.from_numpy(labels).to(dev)),
        multimask_output=multimask_output)
    return low_res.cpu().numpy(), iou.cpu().numpy()


def _fail(requests: List[SamRequest], exc: BaseException) -> None:
    for r in requests:
        if not r.future.done():
            r.future.set_exception(exc)


class SamServer:
    """Continuous batching on one card. ``submit`` returns a future of
    (low-res logits (N, 4h, 4w), IoU (N,)); ``start`` runs the dispatcher
    thread; ``stop`` serves every request queued before it, then joins. An
    exception in a batch is set on every future of that batch.

    The dispatcher enters ``torch.inference_mode`` and selects the model's
    card itself: both belong to the thread, not to the caller.
    """

    def __init__(self, model: sam_lib.Sam, max_batch: int = 8, max_wait_ms: float = 5.0,
                 multimask_output: bool = False):
        self.model = model
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.multimask = multimask_output
        self.batch_sizes: List[int] = []  # of the batches served, a reading for benchmarks
        self._size = model.config.image_encoder.img_size
        self._queue: "queue.Queue[Optional[SamRequest]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None

    # -- public API --------------------------------------------------------

    def submit(self, image, point_coords, point_labels) -> Future:
        req = _request(image, point_coords, point_labels)
        self._queue.put(req)
        return req.future

    def start(self):
        assert self._thread is None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join()
            self._thread = None

    # -- batching core -----------------------------------------------------

    def process_batch(self, requests: List[SamRequest]):
        """Serve ``requests`` as one batch and resolve their futures."""
        try:
            low_res, iou = run_batch(self.model, *_pack_requests(requests, len(requests),
                                                                 self._size),
                                     self.multimask)
        except Exception as e:
            _fail(requests, e)
            return
        self.batch_sizes.append(len(requests))
        for i, r in enumerate(requests):
            r.future.set_result((low_res[i], iou[i]))

    def _loop(self):
        dev = self.model.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        with torch.inference_mode():
            while True:
                first = self._queue.get()
                if first is None:
                    return
                batch = [first]
                deadline = time.monotonic() + self.max_wait_s
                stop = False
                while len(batch) < self.max_batch:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        req = self._queue.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if req is None:
                        stop = True
                        break
                    batch.append(req)
                self.process_batch(batch)
                if stop:
                    return


class MultiHostSamServer:
    """Continuous batching over a dp x tp mesh, one process per card, every
    process calling :meth:`tick` in lockstep (JAX's SPMD serving model).

    Per tick each rank drains up to ``per_host_batch`` requests from its own
    queue, and the world all-gathers one count, so every rank skips an empty
    tick together. A tensor-parallel group gathers its ranks' requests and
    runs them as one batch through the tp-sharded encoder (the model must
    hold this rank's shards, ``mesh.shard_params``); at tp 1 each rank runs
    its own rows through the kernels. Each rank resolves its own futures.

    A rank whose requests cannot be packed (an image larger than the
    model's input) fails those futures and sends the group no rows; the others' rows run as usual. At tp > 1 the
    group runs one SPMD program: a fault inside :func:`run_batch` that
    strikes one rank alone (out of memory) leaves the others waiting in a
    collective, as in any SPMD program.
    """

    def __init__(self, model: sam_lib.Sam, mesh, per_host_batch: int = 4,
                 multimask_output: bool = False):
        self.model = model
        self.mesh = mesh
        self.per_host = per_host_batch
        self.multimask = multimask_output
        self._size = model.config.image_encoder.img_size
        self._queue: "queue.Queue[SamRequest]" = queue.Queue()
        self._tp = mesh_lib.group_of(mesh, "tp")

    def submit(self, image, point_coords, point_labels) -> Future:
        req = _request(image, point_coords, point_labels)
        self._queue.put(req)
        return req.future

    def pending(self) -> int:
        return self._queue.qsize()

    @torch.inference_mode()
    def tick(self) -> int:
        """One collective serving step; every process must call in lockstep.
        Returns the number of this rank's requests resolved this tick,
        served or failed."""
        batch: List[SamRequest] = []
        while len(batch) < self.per_host:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        count = torch.tensor([len(batch)], dtype=torch.int64, device=distributed.comm_device())
        dist.all_reduce(count)
        if int(count) == 0:
            return 0
        n = len(batch)
        try:
            mine = _pack_requests(batch, n, self._size)
        except Exception as e:  # a bad request fails its rank's batch, before any collective
            _fail(batch, e)
            mine, batch = None, []
        tp = self._tp.size()
        first = 0
        try:
            if tp == 1:
                if not batch:
                    return n
                low_res, iou = run_batch(self.model, *mine, self.multimask)
            else:
                # every rank of the group sends its packed rows, None where its
                # pack failed, so the group runs the rows it has together
                parts: List = [None] * tp
                dist.all_gather_object(parts, mine, group=self._tp)
                rows = [0 if p is None else len(p[0]) for p in parts]
                first = sum(rows[:dist.get_rank(self._tp)])
                if sum(rows) == 0:
                    return n
                packed = [np.concatenate([p[j] for p in parts if p is not None])
                          for j in range(3)]
                with mesh_lib.tensor_parallel(self.mesh):
                    low_res, iou = run_batch(self.model, *packed, self.multimask)
        except Exception as e:
            _fail(batch, e)
            return n
        for i, r in enumerate(batch):
            r.future.set_result((low_res[first + i], iou[first + i]))
        return n
