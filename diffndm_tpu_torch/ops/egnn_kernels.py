"""The EGNN edge-chain kernels: wrappers, plain versions, build.

Two functions carry nearly all of the denoiser's device work, and each
is a hand-written CUDA kernel for Hopper (``csrc/egnn_edge.cu``):

- ``gcl_messages``: out_i = sum_j adj_ij * m_ij / norm_factor, where
  m_ij = silu(silu(a_i + b_j + d2c_ij*we0 + d2i_ij*we1) @ W2 + b2),
  optionally gated by sigmoid(m_ij . watt + batt).  [B, N, H]
- ``edge_vector_reduce``: the same chain up to m, then a scalar
  phi_ij = m_ij . wout (tanh-clamped), weighting the normalised
  difference or cross-product direction.  [B, N, 3]
- ``edge_vector_reduce_pair``: the sum of two such reductions over the
  same graph, the first along the difference and the second along the
  cross direction, each with its own weights, in one launch.

They take the same arguments as the JAX package's Pallas kernels
(``diffndm_tpu/ops/pallas_egnn.py``), without the TPU tile options.  A
wrapper given CPU tensors computes its plain PyTorch version
(``*_plain``); given CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts launches per kernel (the pair launches the
``edge_vector_reduce`` kernel once).  On the card the product by W2 runs
on the tensor cores as a three-term TF32 split, which keeps fp32-level
accuracy; the plain versions are plain fp32.  The kernels have no
backward yet: on the card a wrapper raises when grad mode is on and an
argument requires grad (``refuse_grad``) rather than return a result
with no gradient; the plain versions are differentiable.

The kernels are compiled at first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/`` at the repository
root, cached by a hash of the source and flags, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import weakref
from collections import OrderedDict
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "egnn_edge.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SUPPORTED_HIDDEN = (128, 192, 256)
# the kernels pack a column index into 16 bits and keep a block's edge
# list in shared memory
MAX_NODES = 4096

# kernel launches per wrapper; reset with reset_launches()
LAUNCHES = {"gcl_messages": 0, "edge_vector_reduce": 0}

# memory budget of one row chunk of the plain [B, T, N, H] chain
_PLAIN_CHUNK_ELEMS = 1 << 24


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _flags(profile: bool) -> tuple:
    return NVCC_FLAGS + (("-DEGNN_PROFILE",) if profile else ())


def library_path(profile: bool = False) -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(_flags(profile)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"egnn_edge-{tag}.so"


def build_library(profile: bool = False) -> Path:
    """Compile csrc/egnn_edge.cu unless this source's build exists.
    The compiler's register/spill report lands beside it (``.log``).
    ``profile`` builds the variant with cycle counters per phase."""
    so = library_path(profile)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([_nvcc(), *_flags(profile), "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


# set before the first launch to run the build with cycle counters
PROFILE_BUILD = False
PROFILE_FIELDS = ("setup", "wait", "request", "mma", "loop", "", "passes",
                  "blocks")


@functools.lru_cache(maxsize=None)
def _load(profile: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(profile)))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.egnn_gcl_messages.argtypes = [p] * 11 + [i, i, i, i, f, p]
    lib.egnn_gcl_messages.restype = i
    lib.egnn_edge_vector_reduce.argtypes = (
        [p] * 12 + [i, i, i, i, i, f, f, i, f, p])
    lib.egnn_edge_vector_reduce.restype = i
    lib.egnn_edge_vector_reduce_pair.argtypes = (
        [p] * 18 + [i, i, i, i, i, f, f, f, p])
    lib.egnn_edge_vector_reduce_pair.restype = i
    lib.egnn_rows_per_block.argtypes = [i] * 6
    lib.egnn_rows_per_block.restype = i
    return lib


def _library() -> ctypes.CDLL:
    return _load(PROFILE_BUILD)


def launch_grid(name: str, bsz: int, n: int, h: int,
                n_rows: Optional[int] = None) -> tuple:
    """(blocks, rows per block) of the launch that wrapper ``name`` makes
    at these sizes, as the library picks them for this card."""
    rows = _clamp_rows(n, n_rows)
    n_sets = 2 if name == "edge_vector_reduce_pair" else 1
    per_block = _library().egnn_rows_per_block(
        bsz, n, h, rows, n_sets, int(name != "gcl_messages"))
    if per_block <= 0 or rows == 0:
        return 0, per_block
    return -(-rows // per_block) * bsz * n_sets, per_block


def read_profile() -> dict:
    """Cycles that thread 0 of every block spent per phase since the last
    call, summed over blocks, with the counts of passes and blocks (the
    ``PROFILE_BUILD`` variant only).  Synchronises the device."""
    buf = (ctypes.c_ulonglong * 8)()
    err = _load(True).egnn_read_profile(buf)
    if err != 0:
        raise RuntimeError(f"read_profile: CUDA error {err}")
    return {k: int(v) for k, v in zip(PROFILE_FIELDS, buf) if k}


def _launch(name: str, device: torch.device, entry, *args) -> None:
    """Call a C entry on the device's current stream; raise on its error."""
    if device.index == torch.cuda.current_device():
        err = entry(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = entry(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (error {err})")


def refuse_grad(name: str, *args) -> None:
    """Raise when autograd would need a gradient through a kernel: grad
    mode is on and a tensor argument (or one of a pair) requires grad."""
    if not torch.is_grad_enabled():
        return
    for arg in args:
        for t in (arg if isinstance(arg, (tuple, list)) else (arg,)):
            if isinstance(t, torch.Tensor) and t.requires_grad:
                raise RuntimeError(
                    f"{name}: the hand-written CUDA kernels have no backward "
                    "yet, and an input requires grad; run under "
                    "torch.no_grad(), or on the CPU, where the plain "
                    "versions are differentiable")


def _check_cuda(name: str, tensors: dict, shapes: dict) -> dict:
    """Refuse what the kernels do not take; return each tensor's address."""
    dev = tensors["a"].device
    ptrs = {}
    for key, t in tensors.items():
        ptr = t.data_ptr()
        if (t.device != dev or t.dtype is not torch.float32 or ptr % 16
                or t.shape != shapes[key] or not t.is_contiguous()):
            _refuse(name, key, t, dev, shapes[key])
        ptrs[key] = ptr
    return ptrs


def _refuse(name: str, key: str, t: torch.Tensor, dev, shape) -> None:
    if t.device != dev:
        raise ValueError(f"{name}: {key} is on {t.device}, a on {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {key} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {key} must be 16-byte aligned")
    raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                     f"expected {shape}")


def _shapes(bsz: int, n: int, h: int) -> dict:
    return {"a": (bsz, n, h), "b": (bsz, n, h), "d2c": (bsz, n, n),
            "d2i": (bsz, n, n), "adj": (bsz, n, n), "we": (2, h),
            "w2": (h, h), "b2": (h,), "watt": (h, 1), "batt": (1,),
            "wout": (h, 1), "x": (bsz, n, 3), "center": (bsz, 1, 3)}


def _hidden_ok(name: str, h: int, n: int = 0) -> None:
    if h not in SUPPORTED_HIDDEN:
        raise ValueError(f"{name}: the CUDA kernel takes hidden width in "
                         f"{SUPPORTED_HIDDEN}, got {h}")
    if n > MAX_NODES:
        raise ValueError(f"{name}: the CUDA kernel takes at most "
                         f"{MAX_NODES} nodes, got {n}")


def _clamp_rows(n: int, n_rows: Optional[int]) -> int:
    return n if n_rows is None else max(0, min(n, int(n_rows)))


def _vec_output(shape, rows: int, n: int, device) -> torch.Tensor:
    """The kernel writes rows < ``rows`` only; the rest must read zero."""
    make = torch.empty if rows == n else torch.zeros
    return make(shape, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the TF32 split of W2
# ---------------------------------------------------------------------------

def tf32_round(w: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does; still float32."""
    bits = w.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(w: torch.Tensor) -> torch.Tensor:
    """[..., 2]: ``w`` as a TF32 value and the TF32-rounded remainder.  The
    kernels multiply by both parts, which restores fp32-level accuracy on
    the TF32 tensor cores."""
    big = tf32_round(w)
    return torch.stack([big, tf32_round(w - big)], dim=-1).contiguous()


def pack_w2(w2: torch.Tensor) -> torch.Tensor:
    """W2 [H, H] as the kernels read it: [H/16, 16, H+4, 2].  Chunks of 16
    rows (the k index of the product), each element a ``tf32_split`` pair,
    each row padded by 4 pairs (shared-memory banks), and inside a chunk
    row 4*i + j stored at position 4*j + i (the order in which a thread
    that owns k = 4t..4t+3 meets them in the mma fragments)."""
    h = w2.shape[0]
    split = tf32_split(w2).reshape(h // 16, 4, 4, h, 2)     # [c, i, j, n, 2]
    packed = split.permute(0, 2, 1, 3, 4).reshape(h // 16, 16, h, 2)
    return F.pad(packed, (0, 0, 0, 4)).contiguous()


# data_ptr -> (weak reference to the weight, its version, its packed
# split).  The weights are constant over a sampling run, so each is packed
# once.
_SPLIT_CACHE: "OrderedDict[int, tuple]" = OrderedDict()
_SPLIT_CACHE_SIZE = 64


def split_w2(w2: torch.Tensor) -> torch.Tensor:
    """``pack_w2(w2)``, cached per weight tensor.  An entry holds only
    for the very tensor object it was made from and for its version
    counter, so a weight updated in place, or another tensor that came to
    lie at the same address, is split anew."""
    key = w2.data_ptr()
    hit = _SPLIT_CACHE.get(key)
    if hit is not None and hit[0]() is w2 and hit[1] == w2._version:
        return hit[2]
    split = pack_w2(w2.detach())
    _SPLIT_CACHE[key] = (weakref.ref(w2), w2._version, split)
    _SPLIT_CACHE.move_to_end(key)
    while len(_SPLIT_CACHE) > _SPLIT_CACHE_SIZE:
        _SPLIT_CACHE.popitem(last=False)
    return split


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _row_chunk(bsz: int, n: int, h: int) -> int:
    return max(1, min(n, _PLAIN_CHUNK_ELEMS // max(1, bsz * n * h)))


def _edge_messages(a, b, d2c, d2i, we, w2, b2):
    """m = silu(silu(a_i + b_j + d2c*we0 + d2i*we1) @ W2 + b2) for a row
    chunk: a [B, T, H], d2c/d2i [B, T, N] -> [B, T, N, H]."""
    z = (a[:, :, None, :] + b[:, None, :, :]
         + d2c[..., None] * we[0] + d2i[..., None] * we[1])
    return F.silu(F.silu(z) @ w2 + b2)


def gcl_messages_plain(a, b, d2c, d2i, adj, we, w2, b2, watt, batt=None,
                       attention: bool = True, norm_factor: float = 100.0):
    bsz, n, h = a.shape
    out = torch.empty((bsz, n, h), dtype=torch.float32, device=a.device)
    step = _row_chunk(bsz, n, h)
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        m = _edge_messages(a[:, i0:i1], b, d2c[:, i0:i1], d2i[:, i0:i1],
                           we, w2, b2)
        if attention:
            att = m @ watt
            if batt is not None:
                att = att + batt
            m = m * torch.sigmoid(att)
        m = m * adj[:, i0:i1, :, None]
        out[:, i0:i1] = m.sum(dim=2) / norm_factor
    return out


def edge_vector_reduce_plain(a, b, d2c, d2i, adj, x, center, we, w2, b2,
                             wout, tanh: bool = True,
                             coords_range: float = 15.0,
                             norm_constant: float = 1.0, cross: bool = False,
                             norm_factor: float = 100.0,
                             n_rows: Optional[int] = None):
    bsz, n, h = a.shape
    rows = _clamp_rows(n, n_rows)
    out = torch.zeros((bsz, n, 3), dtype=torch.float32, device=a.device)
    step = _row_chunk(bsz, n, h)
    for i0 in range(0, rows, step):
        i1 = min(rows, i0 + step)
        m = _edge_messages(a[:, i0:i1], b, d2c[:, i0:i1], d2i[:, i0:i1],
                           we, w2, b2)
        phi = (m @ wout)[..., 0]                       # [B, T, N]
        if tanh:
            phi = torch.tanh(phi) * coords_range
        w = phi * adj[:, i0:i1]
        xr = x[:, i0:i1, None, :]                      # [B, T, 1, 3]
        xc = x[:, None, :, :]                          # [B, 1, N, 3]
        if cross:
            v = torch.linalg.cross(xr - center[:, :, None, :],
                                   xc - center[:, :, None, :])
            norm = torch.sqrt((v * v).sum(-1, keepdim=True))
            v = v / (norm + norm_constant)
        else:
            d = xr - xc
            radial = (d * d).sum(-1, keepdim=True)
            v = d / (torch.sqrt(radial + 1e-8) + norm_constant)
        out[:, i0:i1] = (v * w[..., None]).sum(dim=2) / norm_factor
    return out


def edge_vector_reduce_pair_plain(a, b, d2c, d2i, adj, x, center, we, w2, b2,
                                  wout, tanh: bool = True,
                                  coords_range: float = 15.0,
                                  norm_constant: float = 1.0,
                                  norm_factor: float = 100.0,
                                  n_rows: Optional[int] = None):
    parts = [edge_vector_reduce_plain(
        a[s], b[s], d2c, d2i, adj, x, center, we[s], w2[s], b2[s], wout[s],
        tanh, coords_range, norm_constant, bool(s), norm_factor, n_rows)
        for s in (0, 1)]
    return parts[0] + parts[1]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def gcl_messages(a, b, d2c, d2i, adj, we, w2, b2, watt, batt=None,
                 attention: bool = True, norm_factor: float = 100.0):
    """a, b: [B, N, H] node projections (edge_dst bias folded into b);
    d2c/d2i/adj: [B, N, N]; we: [2, H]; w2: [H, H]; b2: [H]; watt: [H, 1];
    batt: [1] or None.  Returns [B, N, H] float32."""
    if a.device.type == "cpu":
        return gcl_messages_plain(a, b, d2c, d2i, adj, we, w2, b2, watt,
                                  batt, attention, norm_factor)
    if a.device.type != "cuda":
        raise ValueError(f"gcl_messages: unsupported device {a.device}")
    refuse_grad("gcl_messages", a, b, d2c, d2i, adj, we, w2, b2, watt, batt)
    bsz, n, h = a.shape
    _hidden_ok("gcl_messages", h, n)
    if batt is None:
        batt = torch.zeros((1,), dtype=torch.float32, device=a.device)
    ptr = _check_cuda("gcl_messages",
                      dict(a=a, b=b, d2c=d2c, d2i=d2i, adj=adj, we=we, w2=w2,
                           b2=b2, watt=watt, batt=batt), _shapes(bsz, n, h))
    ptr["w2"] = split_w2(w2).data_ptr()
    out = torch.empty((bsz, n, h), dtype=torch.float32, device=a.device)
    _launch("gcl_messages", a.device, _library().egnn_gcl_messages,
            *(ptr[k] for k in ("a", "b", "d2c", "d2i", "adj", "we", "w2",
                               "b2", "watt", "batt")),
            out.data_ptr(), bsz, n, h, int(bool(attention)),
            float(norm_factor))
    LAUNCHES["gcl_messages"] += 1
    return out


def edge_vector_reduce(a, b, d2c, d2i, adj, x, center, we, w2, b2, wout,
                       tanh: bool = True, coords_range: float = 15.0,
                       norm_constant: float = 1.0, cross: bool = False,
                       norm_factor: float = 100.0,
                       n_rows: Optional[int] = None):
    """Returns [B, N, 3] = sum_j adj_ij * phi_ij * v_ij / norm_factor.

    x: [B, N, 3]; center: [B, 1, 3] (joint COM, used when cross=True);
    n_rows: only rows < n_rows are computed, the rest are zero."""
    if a.device.type == "cpu":
        return edge_vector_reduce_plain(a, b, d2c, d2i, adj, x, center, we,
                                        w2, b2, wout, tanh, coords_range,
                                        norm_constant, cross, norm_factor,
                                        n_rows)
    if a.device.type != "cuda":
        raise ValueError(f"edge_vector_reduce: unsupported device {a.device}")
    refuse_grad("edge_vector_reduce", a, b, d2c, d2i, adj, x, center, we, w2,
                b2, wout)
    bsz, n, h = a.shape
    _hidden_ok("edge_vector_reduce", h, n)
    ptr = _check_cuda("edge_vector_reduce",
                      dict(a=a, b=b, d2c=d2c, d2i=d2i, adj=adj, x=x,
                           center=center, we=we, w2=w2, b2=b2, wout=wout),
                      _shapes(bsz, n, h))
    ptr["w2"] = split_w2(w2).data_ptr()
    rows = _clamp_rows(n, n_rows)
    out = _vec_output((bsz, n, 3), rows, n, a.device)
    if rows == 0:
        return out
    _launch("edge_vector_reduce", a.device,
            _library().egnn_edge_vector_reduce,
            *(ptr[k] for k in ("a", "b", "d2c", "d2i", "adj", "x", "center",
                               "we", "w2", "b2", "wout")),
            out.data_ptr(), bsz, n, h, rows, int(bool(tanh)),
            float(coords_range), float(norm_constant), int(bool(cross)),
            float(norm_factor))
    LAUNCHES["edge_vector_reduce"] += 1
    return out


def edge_vector_reduce_pair(a: Sequence[torch.Tensor],
                            b: Sequence[torch.Tensor], d2c, d2i, adj, x,
                            center, we: Sequence[torch.Tensor],
                            w2: Sequence[torch.Tensor],
                            b2: Sequence[torch.Tensor],
                            wout: Sequence[torch.Tensor], tanh: bool = True,
                            coords_range: float = 15.0,
                            norm_constant: float = 1.0,
                            norm_factor: float = 100.0,
                            n_rows: Optional[int] = None):
    """``edge_vector_reduce(..., cross=False)`` with the first weight set
    plus ``edge_vector_reduce(..., cross=True)`` with the second, over the
    same graph, in one launch.  ``a``, ``b``, ``we``, ``w2``, ``b2`` and
    ``wout`` are pairs of tensors (taken as they are: stacking them would
    cost more launches than the pair saves).  Returns [B, N, 3]."""
    name = "edge_vector_reduce_pair"
    for key, pair in dict(a=a, b=b, we=we, w2=w2, b2=b2, wout=wout).items():
        if len(pair) != 2:
            raise ValueError(f"{name}: {key} must be a pair of tensors")
    if a[0].device.type == "cpu":
        return edge_vector_reduce_pair_plain(a, b, d2c, d2i, adj, x, center,
                                             we, w2, b2, wout, tanh,
                                             coords_range, norm_constant,
                                             norm_factor, n_rows)
    if a[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a[0].device}")
    refuse_grad(name, a, b, d2c, d2i, adj, x, center, we, w2, b2, wout)
    bsz, n, h = a[0].shape
    _hidden_ok(name, h, n)
    shapes = _shapes(bsz, n, h)
    # the shared tensors are checked with the first set
    shared = [dict(d2c=d2c, d2i=d2i, adj=adj, x=x, center=center), {}]
    ptrs = [_check_cuda(f"{name}[{s}]",
                        dict(a=a[s], b=b[s], we=we[s], w2=w2[s], b2=b2[s],
                             wout=wout[s], **shared[s]), shapes)
            for s in (0, 1)]
    for s in (0, 1):
        ptrs[s]["w2"] = split_w2(w2[s]).data_ptr()
    if a[1].device != a[0].device:
        raise ValueError(f"{name}: the two sets are on different devices")
    rows = _clamp_rows(n, n_rows)
    out = _vec_output((2, bsz, n, 3), rows, n, a[0].device)
    if rows == 0:
        return out[0]
    _launch(name, a[0].device, _library().egnn_edge_vector_reduce_pair,
            *(ptrs[s][k] for s in (0, 1)
              for k in ("a", "b", "we", "w2", "b2", "wout")),
            *(ptrs[0][k] for k in ("d2c", "d2i", "adj", "x", "center")),
            out.data_ptr(), bsz, n, h, rows, int(bool(tanh)),
            float(coords_range), float(norm_constant), float(norm_factor))
    LAUNCHES["edge_vector_reduce"] += 1
    return out[0] + out[1]
