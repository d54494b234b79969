"""The trainer's optimizer span as multi-tensor CUDA kernels: the gradient
norm and adaptive clip, the MultiSteps amsgrad update, the EMA.

Three wrappers, each over lists of per-leaf tensors (the trainer's
``params``, its gradients, ``AmsgradState``'s ``acc``, ``mu``, ``nu``,
``nu_max``, the EMA), in place:

- ``clip_by_history(grads, buf, count, slot, clip)``: the global norm of
  the gradients; with ``clip``, the adaptive clip (threshold 1.5 * mean +
  2 * std of the first ``count`` entries of the norm buffer ``buf``, the
  gradients scaled by min(threshold / (norm + 1e-12), 1), ``buf[slot] =
  min(norm, threshold)``).  Returns (norm, threshold or None), 0-d tensors
  on the gradients' device: nothing is read back.
- ``amsgrad(params, grads, acc, mu, nu, nu_max, n, update, c1, c2, lr,
  weight_decay)``: ``acc += (g - acc) / n``; with ``update`` the inner
  step of optax's ``chain(scale_by_amsgrad(), add_decayed_weights,
  scale_by_learning_rate)`` on the accumulated mean, then ``acc = 0``.
- ``ema(ema, params, decay)``: ``e = p`` at decay 0, else ``e = d e +
  (1 - d) p``.

Given CPU tensors a wrapper computes its plain PyTorch version
(``*_plain``: a loop over the leaves, a few ops each, counted in
``PLAIN_CALLS``); given CUDA tensors it launches the kernels of
``csrc/fused_optimizer.cu`` (counted per launch in ``LAUNCHES``) or raises
(every tensor fp32, contiguous, on one card, of its leaf's size).  The
kernels repeat the plain versions' arithmetic op for op, so on the card
they give its bits for the same gradients; only the norm's summation
order differs.  The wrappers count their writes in the tensors' version
counters, as PyTorch's in-place ops do.

A launch carries a table of leaves in its parameter space (the leaves'
addresses, sizes and cumulative chunk counts; ``plan``), and each of its
blocks takes ``CHUNK`` elements of one leaf.  A table holds ``CAPACITY``
leaves for its number of pointers per leaf, so a long list takes several
launches: at the 176 leaves of DiffSBDD's CrossDocked model, one norm,
one clip, one scale, two accumulate or three update launches, and two of
the EMA.  The norm sums each leaf's squares in double and adds the
leaves' sums in fp32 in leaf order, as the plain path adds them.  The addresses are read from the lists at every call, so a leaf
swapped in a list is the leaf the kernels touch.

The library is built by ``egnn_kernels.build_library`` (``nvcc`` for
``sm_90a``, ``-fmad=false``) into ``build/`` at first use and loaded with
ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_optimizer.cu"
FLAGS = ("-fmad=false",)
THREADS = 256
CHUNK = 4096           # elements of one leaf per block
PARAM_BYTES = 4096     # the launch parameter space a table must fit in
CAPACITY = {1: 240, 2: 160, 6: 64}   # leaves per table, by pointers a leaf
CLIP_CAPACITY = 960                  # leaves per clip launch
B1, B2, EPS = 0.9, 0.999, 1e-8       # optax.scale_by_amsgrad defaults

# kernel launches per kernel, and calls of the plain versions; reset with
# reset_counts()
LAUNCHES = {"optimizer_norm": 0, "optimizer_clip": 0, "optimizer_scale": 0,
            "optimizer_update": 0, "optimizer_ema": 0}
PLAIN_CALLS = {"clip": 0, "amsgrad": 0, "ema": 0}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def clip_by_history_plain(grads, buf, count: int, slot: int, clip: bool
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    PLAIN_CALLS["clip"] += 1
    gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
    if not clip:
        return gnorm, None
    cnt = max(count, 1)
    valid = torch.arange(buf.shape[0], device=buf.device) < cnt
    mean = torch.where(valid, buf, 0.0).sum() / cnt
    var = torch.where(valid, (buf - mean) ** 2, 0.0).sum() / cnt
    max_norm = 1.5 * mean + 2.0 * torch.sqrt(var)
    scale = torch.clamp_max(max_norm / (gnorm + 1e-12), 1.0)
    for g in grads:
        g.mul_(scale)
    buf[slot] = torch.minimum(gnorm, max_norm)
    return gnorm, max_norm


def amsgrad_plain(params, grads, acc, mu, nu, nu_max, n: int, update: bool,
                  c1: float = 1.0, c2: float = 1.0, lr: float = 0.0,
                  weight_decay: float = 0.0) -> None:
    PLAIN_CALLS["amsgrad"] += 1
    for a, g in zip(acc, grads):
        a.add_((g - a) / n)
    if not update:
        return
    for p, g, m, v, v_max in zip(params, acc, mu, nu, nu_max):
        m.mul_(B1).add_((1.0 - B1) * g)
        v.mul_(B2).add_((1.0 - B2) * g * g)
        torch.maximum(v_max, v / c2, out=v_max)
        u = (m / c1) / (torch.sqrt(v_max) + EPS)
        if weight_decay:
            u = u + weight_decay * p
        p.add_(-lr * u)
    for a in acc:
        a.zero_()


def ema_plain(ema, params, decay: float) -> None:
    PLAIN_CALLS["ema"] += 1
    for e, p in zip(ema, params):
        if decay > 0.0:
            e.mul_(decay).add_((1.0 - decay) * p)
        else:
            e.copy_(p)


# ---------------------------------------------------------------------------
# leaf tables
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Launch:
    """One launch's table: leaves [start, stop) of the list, their sizes,
    the cumulative count of CHUNK-element chunks over them (block b takes
    a chunk of the first leaf whose count passes b), and the index of its
    first chunk among all the plan's (its blocks' slots in the norm's
    partial sums)."""
    start: int
    stop: int
    numel: np.ndarray
    chunk_end: np.ndarray
    first_chunk: int

    @property
    def blocks(self) -> int:
        return int(self.chunk_end[-1])


@functools.lru_cache(maxsize=64)
def plan(numels: Tuple[int, ...], depth: int, chunk: int = CHUNK,
         capacity: Optional[int] = None) -> Tuple[Launch, ...]:
    """The launches that cover leaves of these sizes, each table holding
    at most ``capacity`` leaves (``CAPACITY[depth]``): every leaf in one
    table, a leaf of n elements in ceil(n / chunk) blocks (none when
    empty)."""
    cap = CAPACITY[depth] if capacity is None else capacity
    out, first = [], 0
    for start in range(0, len(numels), cap):
        sizes = np.asarray(numels[start:start + cap], dtype=np.int64)
        if sizes.max(initial=0) >= 2 ** 31:
            raise ValueError(f"a leaf of {int(sizes.max())} elements is "
                             f"more than the kernels index")
        ends = np.cumsum(-(-sizes // chunk))
        out.append(Launch(start, start + len(sizes), sizes.astype(np.int32),
                          ends.astype(np.int32), first))
        first += int(ends[-1])
    return tuple(out)


@functools.lru_cache(maxsize=64)
def clip_plan(numels: Tuple[int, ...], chunk: int = CHUNK,
              capacity: int = CLIP_CAPACITY
              ) -> Tuple[Tuple[int, np.ndarray], ...]:
    """The clip's launches: per range of at most ``capacity`` leaves, its
    first chunk and each leaf's chunk end among the norm pass's partial
    sums (every plan's launches in order, so leaf j's chunks follow leaf
    j - 1's)."""
    ends = np.cumsum(-(-np.asarray(numels, dtype=np.int64) // chunk))
    return tuple((int(ends[a - 1]) if a else 0,
                  ends[a:a + capacity].astype(np.int32))
                 for a in range(0, len(numels), capacity)) or \
        ((0, np.zeros(0, dtype=np.int32)),)


# ---------------------------------------------------------------------------
# build, load, launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from diffndm_tpu_torch.ops.egnn_kernels import build_library

    lib = ctypes.CDLL(str(build_library(source=SOURCE, flags=FLAGS)))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    table = [p, i, p, p, i]
    lib.fo_layout.argtypes, lib.fo_layout.restype = [p], None
    for name, extra in (("fo_sum_squares", [p]), ("fo_scale", [p]),
                        ("fo_accumulate", [f]),
                        ("fo_amsgrad", [f] * 10 + [i]),
                        ("fo_ema", [f, f, i])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = table + extra + [p], i
    lib.fo_clip.argtypes = [p, i, i, p, i, i, p, i, i, f, i, i, p, p]
    lib.fo_clip.restype = i
    layout = (ctypes.c_int * 7)()
    lib.fo_layout(layout)
    want = (THREADS, CHUNK, PARAM_BYTES, CAPACITY[1], CAPACITY[2],
            CAPACITY[6], CLIP_CAPACITY)
    if tuple(layout) != want:
        raise RuntimeError(f"{SOURCE.name} was built with the layout "
                           f"{tuple(layout)}, the wrapper expects {want}")
    return lib


def _launch(name: str, device: torch.device, entry, *args) -> None:
    from diffndm_tpu_torch.ops.egnn_kernels import _launch as launch

    launch(name, device, entry, *args)
    LAUNCHES[name] += 1


_dtype = operator.attrgetter("dtype")


def _addresses(name: str, ts: Sequence[torch.Tensor],
               numels: Tuple[int, ...], device: torch.device) -> tuple:
    """The tensors' addresses; refuses what the kernels do not take."""
    index = device.index if device.type == "cuda" else -1
    if not (len(ts) == len(numels)
            and tuple(map(torch.Tensor.numel, ts)) == numels
            and set(map(_dtype, ts)) <= {torch.float32}
            and set(map(torch.Tensor.get_device, ts)) <= {index}
            and all(map(torch.Tensor.is_contiguous, ts))):
        _refuse(name, ts, numels, device)
    return tuple(map(torch.Tensor.data_ptr, ts))


def _refuse(name, ts, numels, device) -> None:
    if len(ts) != len(numels):
        raise ValueError(f"{name}: {len(ts)} tensors for {len(numels)} "
                         f"leaves")
    for i, (t, n) in enumerate(zip(ts, numels)):
        if (t.dtype != torch.float32 or t.device != device
                or t.numel() != n or not t.is_contiguous()):
            raise ValueError(
                f"{name}: leaf {i} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous {t.is_contiguous()}); the kernels "
                f"take contiguous float32 of {n} elements on {device}")


class _Tables:
    """The plan's launches for these lists (one row of addresses each):
    ``args(launch)`` gives a launch's table arguments."""

    def __init__(self, name: str, lists, device: torch.device, depth: int):
        self.numels = tuple(map(torch.Tensor.numel, lists[0]))
        self.ptrs = np.array([_addresses(name, ts, self.numels, device)
                              for ts in lists],
                             dtype=np.uint64).reshape(len(lists), -1)
        self.launches = [lc for lc in plan(self.numels, depth) if lc.blocks]

    def args(self, launch: Launch) -> tuple:
        return (self.ptrs.ctypes.data + 8 * launch.start, self.ptrs.shape[1],
                launch.numel.ctypes.data, launch.chunk_end.ctypes.data,
                launch.stop - launch.start)


def _written(*lists) -> None:
    """Count the kernels' writes in the tensors' version counters, as an
    in-place op of PyTorch's would: what keys a cache on a weight's
    version (``egnn_kernels``' packed W2) or checks a saved tensor
    (autograd) sees the change."""
    for ts in lists:
        torch.autograd.graph.increment_version(ts)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _recip(x: float) -> float:
    """PyTorch's CUDA division by a host scalar multiplies by its
    reciprocal, taken in double and rounded to fp32."""
    return float(np.float32(1.0 / x))


def _clip_cuda(grads, buf, count, slot, clip):
    lib, dev = _library(), buf.device
    if buf.dtype != torch.float32 or not buf.is_contiguous() or \
            buf.dim() != 1 or not 0 <= slot < buf.numel() <= THREADS:
        raise ValueError(f"clip_by_history: the norm buffer must be a "
                         f"contiguous float32 vector of at most {THREADS} "
                         f"with slot {slot} in it")
    tables = _Tables("clip_by_history", [grads], dev, 1)
    n_partials = sum(lc.blocks for lc in tables.launches)
    partials = torch.empty(max(n_partials, 1), dtype=torch.float64,
                           device=dev)
    stats = torch.empty(4, device=dev)
    for launch in tables.launches:
        _launch("optimizer_norm", dev, lib.fo_sum_squares,
                *tables.args(launch),
                partials.data_ptr() + 8 * launch.first_chunk)
    cnt = max(count, 1)
    ranges = clip_plan(tables.numels)
    for r, (begin, ends) in enumerate(ranges):
        _launch("optimizer_clip", dev, lib.fo_clip, ends.ctypes.data, begin,
                len(ends), partials.data_ptr(), int(r == 0),
                int(r == len(ranges) - 1), buf.data_ptr(), buf.numel(), cnt,
                _recip(cnt), slot, int(clip), stats.data_ptr())
    if not clip:
        return stats[0], None
    for launch in tables.launches:
        _launch("optimizer_scale", dev, lib.fo_scale, *tables.args(launch),
                stats.data_ptr())
    _written(grads, [buf])
    return stats[0], stats[1]


def _amsgrad_cuda(params, grads, acc, mu, nu, nu_max, n, update, c1, c2, lr,
                  weight_decay):
    lib, dev = _library(), params[0].device
    if not update:
        tables = _Tables("amsgrad", [grads, acc], dev, 2)
        for launch in tables.launches:
            _launch("optimizer_update", dev, lib.fo_accumulate,
                    *tables.args(launch), _recip(n))
        _written(acc)
        return
    tables = _Tables("amsgrad", [params, grads, acc, mu, nu, nu_max], dev,
                     6)
    consts = (_recip(n), _f32(B1), _f32(1.0 - B1), _f32(B2), _f32(1.0 - B2),
              _recip(c1), _recip(c2), _f32(EPS), _f32(weight_decay),
              _f32(-lr), int(bool(weight_decay)))
    for launch in tables.launches:
        _launch("optimizer_update", dev, lib.fo_amsgrad,
                *tables.args(launch), *consts)
    _written(params, acc, mu, nu, nu_max)


def _ema_cuda(ema, params, decay):
    lib, dev = _library(), params[0].device
    copy = not decay > 0.0
    d, omd = (0.0, 0.0) if copy else (_f32(decay), _f32(1.0 - decay))
    tables = _Tables("ema", [params, ema], dev, 2)
    for launch in tables.launches:
        _launch("optimizer_ema", dev, lib.fo_ema, *tables.args(launch), d,
                omd, int(copy))
    _written(ema)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def clip_by_history(grads: List[torch.Tensor], buf: torch.Tensor,
                    count: int, slot: int, clip: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradients' global norm and, with ``clip``, the adaptive clip in
    place (module docstring).  Returns (norm, threshold or None)."""
    if buf.is_cuda:
        return _clip_cuda(grads, buf, count, slot, clip)
    return clip_by_history_plain(grads, buf, count, slot, clip)


def amsgrad(params, grads, acc, mu, nu, nu_max, n: int, update: bool,
            c1: float = 1.0, c2: float = 1.0, lr: float = 0.0,
            weight_decay: float = 0.0) -> None:
    """The n-th micro-step of an accumulation window; with ``update`` the
    inner amsgrad step with bias corrections ``c1``, ``c2`` (module
    docstring)."""
    if params and params[0].is_cuda:
        return _amsgrad_cuda(params, grads, acc, mu, nu, nu_max, n, update,
                             c1, c2, lr, weight_decay)
    return amsgrad_plain(params, grads, acc, mu, nu, nu_max, n, update, c1,
                         c2, lr, weight_decay)


def ema(ema_params, params, decay: float) -> None:
    """The EMA of ``params`` in ``ema_params``, in place."""
    if params and params[0].is_cuda:
        return _ema_cuda(ema_params, params, decay)
    return ema_plain(ema_params, params, decay)
