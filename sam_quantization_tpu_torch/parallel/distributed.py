"""The process world: bootstrap, rank and size, host-side reductions.

Counterpart of ``sam_quantization_tpu/parallel/distributed.py`` (the
reference's ``utils/distributed.py`` and its ``dist.init_process_group``,
train_sm.py:630-638). One process drives one card. :func:`initialize` reads
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``) or explicit arguments and starts NCCL on
``cuda:{local_rank}``; ``backend="gloo"`` with ``device="cpu"`` runs the
same world on the CPU, as the tests do. Nothing falls back to the CPU or to
gloo when there is no card.

Without an initialized world every helper answers for a world of one.
"""

from __future__ import annotations

import os
import socket
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env_world_size() -> int:
    """The world size torchrun announces (``WORLD_SIZE``), 1 without it."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize(
    backend: str = "nccl",
    device: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> torch.device:
    """Join the process world (``dist.init_process_group`` counterpart) and
    return this rank's device.

    Arguments left out come from torchrun's environment, then from a world
    of one. The rendezvous is ``init_method``, else ``env://`` when
    ``MASTER_ADDR`` is set, else (a world of one only) a free port on
    127.0.0.1. NCCL binds ``cuda:{LOCAL_RANK}`` (the rank without
    ``LOCAL_RANK``) and raises without a card;
    gloo runs on ``device`` (default the CPU). A world already joined is
    kept as it is.
    """
    world_size = env_world_size() if world_size is None else world_size
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA device; pass backend='gloo' "
                               "and device='cpu' to run on the CPU")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device or "cpu")
    if dist.is_initialized():
        return dev
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://127.0.0.1:{free_port()}"
        else:
            raise ValueError(f"a world of {world_size} ranks needs MASTER_ADDR/MASTER_PORT "
                             "or init_method")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return dev


def destroy() -> None:
    """Leave the world, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def comm_device() -> torch.device:
    """Where this world's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def get_rank() -> int:
    """ref utils/distributed.py:6-13 (``torch.distributed.get_rank``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    """ref utils/distributed.py:16-22."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def reduce_loss_dict(loss_dict: Dict[str, float]) -> Dict[str, float]:
    """Average scalar metrics over the world (ref reduce_loss_dict,
    utils/distributed.py:25-47, which reduces to rank 0; here every rank gets
    the mean, which subsumes that). The values travel as float32 in sorted
    key order, as in the JAX package."""
    world = get_world_size()
    if world == 1:
        return dict(loss_dict)
    keys = sorted(loss_dict)
    vals = torch.tensor([float(loss_dict[k]) for k in keys], dtype=torch.float32,
                        device=comm_device())
    dist.all_reduce(vals)
    mean = (vals / world).cpu().numpy()
    return {k: float(v) for k, v in zip(keys, mean)}


def barrier() -> None:
    """ref dist.barrier (train_sm.py:469)."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in rank
    order (forward only: no gradient flows back through it)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def average_gradients(params, group=None) -> None:
    """Replace each parameter's gradient by its mean over ``group`` (the
    world by default), in place: one all-reduce a gradient, all in flight
    together, then a division by the group size (exact for a group of one).
    No second copy of the gradients is made."""
    grads = [p.grad for p in params]
    for work in [dist.all_reduce(g, group=group, async_op=True) for g in grads]:
        work.wait()
    n = dist.get_world_size(group)
    for g in grads:
        g.div_(n)


def local_batch(global_array: np.ndarray, mesh) -> np.ndarray:
    """This rank's rows of a host batch that every rank holds whole (the
    DistributedSampler counterpart, utils/distributed.py:50-57): the rows of
    its ``"dp"`` coordinate on ``mesh``. The ranks of one tensor-parallel
    group get the same rows."""
    n, i = mesh["dp"].size(), mesh.get_local_rank("dp")
    rows = len(global_array)
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over {n} data-parallel ranks")
    per = rows // n
    return global_array[i * per:(i + 1) * per]
