"""Several processes, one image (counterpart of
`jpegtpu/parallel/multihost.py`), over torch.distributed.

Every process runs the same program on the whole image and encodes only
its own shards (`local_shard_indices`); the processes exchange a few
bytes: 2-pass symbol counts (an all_reduce), an overflow flag, and the
stuffed segments, lengths first (`gather_segments`). These travel as CPU
tensors over gloo: they are small, and NCCL refuses two ranks on one
card.

Usage (the same program in every process):

    from jpegtpu_torch.parallel import multihost, sharding
    multihost.initialize("tcp://localhost:29500", world_size=2, rank=r)
    mesh = multihost.global_mesh(["cuda:0"])   # one shard a process
    data = sharding.encode_grayscale_sharded(image, cfg, mesh=mesh)
    if multihost.is_coordinator():
        open(out, "wb").write(data)
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, timeout_s: float = 600.0) -> None:
    """Join the gloo process group: torch.distributed.init_process_group
    with `init_method` (e.g. "tcp://localhost:29500"), or from the
    environment (MASTER_ADDR, RANK, WORLD_SIZE) when none is given.
    Idempotent; a no-op when no rendezvous is configured, so a single
    process runs the same code."""
    if dist.is_initialized():
        return
    env = all(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if init_method is None and not env:
        return
    dist.init_process_group(
        "gloo", init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def local_devices() -> list:
    """This process's devices: every CUDA device it sees."""
    from ..pipeline import resolve_device

    return [resolve_device(f"cuda:{i}")
            for i in range(max(1, torch.cuda.device_count()))]


def global_mesh(devices=None) -> list:
    """The mesh over every process: each process's devices (`devices`, or
    local_devices()), in process order, one shard each. A collective:
    every process calls it."""
    from ..pipeline import resolve_device

    local = [resolve_device(d) for d in (devices or local_devices())]
    if process_count() == 1:
        return local
    names = [None] * process_count()
    dist.all_gather_object(names, [str(d) for d in local])
    if len({len(n) for n in names}) != 1:
        raise ValueError("every process must bring as many devices")
    return [torch.device(d) for n in names for d in n]


def local_shard_indices(mesh) -> list:
    """Mesh positions owned by this process: its equal, contiguous share
    of the mesh (global_mesh's order)."""
    n, p = len(mesh), process_count()
    if n % p:
        raise ValueError(f"a mesh of {n} does not split over {p} processes")
    r = process_index()
    return list(range(r * n // p, (r + 1) * n // p))


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum a small tensor over the processes (jpegtpu's psum of the 2-pass
    counts); returns a CPU tensor."""
    t = t.cpu()
    if process_count() > 1:
        dist.all_reduce(t)
    return t


def any_process(flag: bool) -> bool:
    """Whether `flag` holds in any process (an overflow in any shard sends
    every process to the next rung together)."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out)


def gather_segments(ids, segments, n_total: int) -> list:
    """Every process's stuffed segments, in scan order, in every process
    (jpegtpu's gather_segments_multihost): ids [m] and segments [m] are
    this process's (m equal in every process). The segments travel as
    one buffer a process, padded to the largest total, after their
    lengths: n_processes * max total bytes, not n_segments * the longest
    segment."""
    if process_count() == 1:
        out = [None] * n_total
        for i, seg in zip(ids, segments):
            out[i] = seg
        return out
    flat = np.frombuffer(b"".join(segments), np.uint8)
    size = int(_all_gather(torch.tensor([flat.size])).max())
    payload = torch.zeros(max(size, 1), dtype=torch.uint8)
    payload[:flat.size] = torch.from_numpy(flat.copy())
    ids_all = _all_gather(torch.tensor(list(ids), dtype=torch.int64))
    lens_all = _all_gather(torch.tensor([len(s) for s in segments],
                                        dtype=torch.int64))
    bufs = _all_gather(payload).numpy()
    out: list = [None] * n_total
    for p in range(ids_all.shape[0]):
        off = 0
        for gid, ln in zip(ids_all[p].tolist(), lens_all[p].tolist()):
            out[gid] = bufs[p, off:off + ln].tobytes()
            off += ln
    if any(s is None for s in out):
        raise RuntimeError("a shard's segment is missing")
    return out
