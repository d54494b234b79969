"""Data parallelism over processes: the counterpart of the JAX package's
device mesh (``diffndm_tpu/parallel/mesh.py``).

JAX shards the batch over a mesh's ``data`` axis, replicates the
parameters, and XLA inserts the collectives.  Here every rank is a process
with its own device and its own rows, and the collectives are
``torch.distributed`` calls:

- ``DataGroup`` holds the rank, the world size, the backend and the
  device; ``init_data_group`` makes one from an explicit ``init_method``
  or from ``torchrun``'s environment, and gives ``None`` (one process,
  no collective) when neither is there;
- ``pad_rows`` repeat-pads a batch that the ranks do not divide, by the
  JAX trainer's ``_pad_to_mesh`` index rule, and ``shard_rows`` takes a
  rank's contiguous rows, as ``PartitionSpec("data")`` shards them;
- ``replicate`` broadcasts rank 0's tensors, ``all_reduce_flat`` sums a
  list of tensors through one flat buffer, ``all_gather_rows``
  concatenates every rank's rows;
- ``spawn`` starts one process per rank with a ``file://`` rendezvous.

The backend is always the caller's choice: ``"nccl"`` when each rank has
a card of its own, ``"gloo"`` on the CPU and where ranks share a card.
Gloo moves CUDA tensors in broadcast and all-reduce only, so under gloo
``all_gather_rows`` stages CUDA tensors through the host; nothing falls
back from one backend to another.  The JAX mesh's ``model`` axis has no
counterpart: it is size 1 and unused there.
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from diffndm_tpu_torch.structs import NodeBatch

# how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT = 600.0


@dataclass(frozen=True)
class DataGroup:
    """This process's place in the data-parallel group."""

    rank: int
    world: int
    backend: str
    device: torch.device

    def rows(self, b: int) -> slice:
        """This rank's contiguous rows of a batch of ``b`` rows."""
        if b % self.world:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{self.world} ranks")
        n = b // self.world
        return slice(self.rank * n, (self.rank + 1) * n)


def launched_by_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_data_group(backend: str, init_method: Optional[str] = None,
                    rank: Optional[int] = None, world: Optional[int] = None,
                    device=None, timeout: float = DEFAULT_TIMEOUT
                    ) -> Optional[DataGroup]:
    """Join the process group.  Without ``init_method`` the rank and world
    size come from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``), and without that environment there is one process
    and the result is None.  ``device`` defaults to ``cuda:<local rank>``
    under NCCL and to the CPU under gloo."""
    local = rank
    if init_method is None:
        if not launched_by_torchrun():
            return None
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        init_method = "env://"
    if device is None:
        device = f"cuda:{local}" if backend == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout))
    return DataGroup(rank, world, backend, device)


def close(group: Optional[DataGroup]) -> None:
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def pad_index(b: int, n: int) -> np.ndarray:
    """The rows of a batch of ``b`` repeat-padded to a multiple of ``n``
    (the JAX trainer's ``_pad_to_mesh``)."""
    return np.concatenate([np.arange(b), np.arange((-b) % n) % b])


def pad_rows(ligand: NodeBatch, pocket: NodeBatch, world: int):
    """Repeat-pad both batches to a multiple of ``world`` rows; the
    repeated rows weigh twice in that step, as in JAX."""
    b = ligand.x.shape[0]
    if b % world == 0:
        return ligand, pocket
    idx = torch.from_numpy(pad_index(b, world)).to(ligand.x.device)
    return (NodeBatch(*(t[idx] for t in ligand)),
            NodeBatch(*(t[idx] for t in pocket)))


def shard_rows(tree, rank: int, world: int):
    """A rank's contiguous rows of every tensor in ``tree`` (a tensor, or
    a NamedTuple, tuple or list of them)."""
    if isinstance(tree, torch.Tensor):
        b = tree.shape[0]
        if b % world:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{world} ranks")
        n = b // world
        return tree[rank * n:(rank + 1) * n]
    if hasattr(tree, "_fields"):
        return type(tree)(*(shard_rows(t, rank, world) for t in tree))
    return type(tree)(shard_rows(t, rank, world) for t in tree)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one flat buffer holds one dtype, got {dtypes}")
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, tensors: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def replicate(group: DataGroup, tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite ``tensors`` in place with rank 0's, through one flat
    broadcast."""
    flat = _flat(tensors)
    dist.broadcast(flat, 0)
    with torch.no_grad():
        for t, v in zip(tensors, _unflat(flat, tensors)):
            t.copy_(v)


def all_reduce_flat(group: DataGroup, tensors: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """The sums over the ranks of ``tensors`` (one dtype), through one
    flat buffer and one all-reduce; every rank gets the same bits."""
    flat = _flat(tensors)
    dist.all_reduce(flat)
    return _unflat(flat, tensors)


def all_gather_rows(group: DataGroup, t: torch.Tensor, dim: int = 0
                    ) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (each
    rank gives the same shape)."""
    t = t.contiguous()
    if group.backend == "gloo" and t.is_cuda:
        # gloo all-gathers host tensors only: stage through the host
        parts = [torch.empty_like(t, device="cpu")
                 for _ in range(group.world)]
        dist.all_gather(parts, t.cpu())
        return torch.cat(parts, dim).to(t.device)
    parts = [torch.empty_like(t) for _ in range(group.world)]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim)


def barrier(group: DataGroup) -> None:
    """Wait for every rank (an all-reduce of one element on the group's
    device, which both backends carry, read back on the host)."""
    t = torch.zeros(1, device=group.device)
    dist.all_reduce(t)
    t.item()


def rank0_flag(group: DataGroup, flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank (a decision only rank 0 may take,
    such as one read from its clock)."""
    t = torch.tensor([1.0 if flag else 0.0], device=group.device)
    dist.broadcast(t, 0)
    return bool(t.item())


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, backend, init_method, device, timeout, args,
               results) -> None:
    group = init_data_group(backend, init_method, rank, world, device,
                            timeout)
    try:
        value = fn(group, *args)
        # no rank tears its connections down while a peer still sets its
        # own up or uses them
        barrier(group)
        results.put((rank, value))
    finally:
        close(group)


def spawn(fn: Callable, world: int, backend: str, args: tuple = (),
          devices: Optional[Sequence] = None,
          timeout: Optional[float] = DEFAULT_TIMEOUT,
          collective_timeout: float = DEFAULT_TIMEOUT) -> List[Any]:
    """Run ``fn(group, *args)`` in ``world`` new processes, one per rank,
    and return their results in rank order.  ``fn`` is a top-level
    function whose module imports cheaply; its result is pickled back.
    ``devices[r]`` is rank r's device (default: ``cuda:r`` under NCCL,
    the CPU under gloo).  A rank that raises or exits non-zero, or a run
    longer than ``timeout`` seconds (None: no limit), ends every rank and
    raises here."""
    import torch.multiprocessing as mp

    if devices is None:
        devices = [f"cuda:{r}" if backend == "nccl" else "cpu"
                   for r in range(world)]
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="diffndm-dp-")
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, backend, init, str(devices[r]), collective_timeout,
        args, results)) for r in range(world)]
    deadline = None if timeout is None else time.monotonic() + timeout
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, value = results.get(timeout=0.2)
                out[rank] = value
                continue
            except queue_mod.Empty:
                pass
            if any(p.exitcode not in (None, 0) for p in procs):
                # its peers may fail with it: let them end, name them all
                for p in procs:
                    p.join(2.0)
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                raise RuntimeError(
                    f"data-parallel ranks {bad} of {world} exited with codes "
                    f"{[procs[r].exitcode for r in bad]}")
            if all(p.exitcode == 0 for p in procs):
                try:
                    rank, value = results.get(timeout=5.0)
                except queue_mod.Empty:
                    raise RuntimeError("a data-parallel rank ended "
                                       "without a result") from None
                out[rank] = value
            elif deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"data-parallel ranks still running "
                                   f"after {timeout} s")
        for r, p in enumerate(procs):
            p.join(None if deadline is None
                   else max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"data-parallel rank {r} of {world} "
                                   f"ended with code {p.exitcode}")
    finally:
        for p in procs:
            if p.pid is None:       # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
