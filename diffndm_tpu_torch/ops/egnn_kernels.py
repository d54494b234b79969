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
``edge_vector_reduce`` kernel once).  Each wrapper call is a span named
``kernels.<wrapper>``, each backward ``kernels.gcl_messages_bwd`` or
``kernels.edge_vector_reduce_bwd`` (``utils.profiling.annotate``).  On
the card the product by W2 runs on the tensor cores as a three-term TF32
split, which keeps fp32-level accuracy; the plain versions are plain
fp32.

``compute_dtype="bfloat16"`` runs the Pallas kernels' ``mxu_dtype =
bfloat16`` mode (the JAX package's ``EGNNConfig.compute_dtype``): z, W2, m
and watt / wout are rounded to bf16 (nearest even) as the operands of their
products, whose sums stay fp32; each weight is rounded once per call.  The
inputs and the output stay fp32; the caller rounds what the JAX package
rounds outside its kernels (h, the coordinates, d2i, adj, W_e, and the
aggregate).  On the card this is the bf16 kernel (``wgmma`` with W2 whole
in shared memory, packed by ``pack_w2_bf16``), counted under
``gcl_messages_bf16`` / ``edge_vector_reduce_bf16``.  Its backward is the
VJP of that arithmetic under the cast rule of ``jax.vjp`` and torch
autograd: a cotangent is rounded to bf16 where the forward rounded an
operand (ds = du W2'^T, the gradient of bf16(m) in the gate or phi dot),
and dW2 and dwatt / dwout are summed in fp32 over the call and rounded
once.  On the card it is the bf16 backward kernel (``wgmma`` for its
three products, W2 as ``pack_w2_bf16`` lays it out; counted under
``*_bwd_bf16``), on the CPU the plain backward with
``compute_dtype="bfloat16"``.

In grad mode each wrapper goes through a ``torch.autograd.Function``
(``_GclMessages``, ``_EdgeVectorReduce``) that saves only its inputs and
whose backward recomputes the chain: on the card the hand-written kernel
of ``csrc/egnn_edge_bwd.cu`` (a template per compute dtype, each with an
epilogue for each wrapper; two launches per backward, counted under
``gcl_messages_bwd`` / ``edge_vector_reduce_bwd``; its three products run
on the tensor cores, in fp32 taking W2 and W2^T packed as ``pack_w2`` lays
them out), on the CPU the plain backward (``*_backward_plain``), which
writes the same formula out in PyTorch.  The JAX package's Pallas kernels
have no VJP; these give the gradient that XLA autodiff gives of its dense
path.

The kernels are compiled at first use by ``nvcc`` for ``sm_90a`` into
shared libraries with a plain C interface under ``build/`` at the
repository root (one per source), cached by a hash of the source, the
headers beside it and the flags, and loaded with ctypes.
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

from diffndm_tpu_torch.utils.profiling import annotate

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "egnn_edge.cu"
BWD_SOURCE = SOURCE.with_name("egnn_edge_bwd.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SUPPORTED_HIDDEN = (128, 192, 256)
# the kernels pack a column index into 16 bits and keep a block's edge
# list in shared memory
MAX_NODES = 4096

# kernel launches per kernel (the pair launches the vector kernel, in
# either compute dtype); reset with reset_launches()
LAUNCHES = {"gcl_messages": 0, "edge_vector_reduce": 0,
            "gcl_messages_bwd": 0, "edge_vector_reduce_bwd": 0,
            "gcl_messages_bf16": 0, "edge_vector_reduce_bf16": 0,
            "gcl_messages_bwd_bf16": 0, "edge_vector_reduce_bwd_bf16": 0}
COMPUTE_DTYPES = ("float32", "bfloat16")

# memory budget of one row chunk of the plain [B, T, N, H] chain
_PLAIN_CHUNK_ELEMS = 1 << 24


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _count(name: str, bf16: bool) -> None:
    LAUNCHES[name + ("_bf16" if bf16 else "")] += 1


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


def library_path(profile: bool = False, source: Path = SOURCE,
                 flags: tuple = ()) -> Path:
    """The build of ``source`` under these flags (``flags`` added to the
    common ones): named by a hash of the source, of every header
    (``*.cuh``) beside it and of the flags, so that an edited header is
    built anew."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags(profile) + flags).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_library(profile: bool = False, source: Path = SOURCE,
                  flags: tuple = ()) -> Path:
    """Compile ``source`` (the forward kernels unless ``BWD_SOURCE``, or
    ``fused_optimizer.SOURCE`` with its ``FLAGS``) unless its build
    exists.  The compiler's register/spill report lands beside it
    (``.log``).  ``profile`` builds the variant with cycle counters per
    phase."""
    so = library_path(profile, source, flags)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([_nvcc(), *_flags(profile), *flags, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


# set before the first launch to run the build with cycle counters
PROFILE_BUILD = False
PROFILE_FIELDS = ("setup", "wait", "request", "mma", "loop", "", "passes",
                  "blocks")
# the backward's spans (both epilogues): the whole block, its passes, the
# chunk loops of (3) u = s W2 and (6) ds = du W2^T (fp32) or product (3)
# alone (bf16), (5) dW2 = s^T du, the counts of passes and blocks, and in
# the bf16 kernel the s' chain, product (6), the epilogue of (3) (up to
# du's parts) and that of (6) (up to dz)
PROFILE_BWD_FIELDS = ("block", "pass", "loops", "dw2", "passes", "blocks",
                      "chain", "ds", "epi3", "epi6")


@functools.lru_cache(maxsize=None)
def _load(profile: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(profile)))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for suffix in ("", "_bf16"):
        fn = getattr(lib, "egnn_gcl_messages" + suffix)
        fn.argtypes, fn.restype = [p] * 11 + [i, i, i, i, f, p], i
        fn = getattr(lib, "egnn_edge_vector_reduce" + suffix)
        fn.argtypes, fn.restype = [p] * 12 + [i, i, i, i, i, f, f, i, f, p], i
        fn = getattr(lib, "egnn_edge_vector_reduce_pair" + suffix)
        fn.argtypes, fn.restype = [p] * 18 + [i, i, i, i, i, f, f, f, p], i
        fn = getattr(lib, "egnn_rows_per_block" + suffix)
        fn.argtypes, fn.restype = [i] * 6, i
    return lib


def _library() -> ctypes.CDLL:
    return _load(PROFILE_BUILD)


@functools.lru_cache(maxsize=None)
def _bwd_load(profile: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(profile, BWD_SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.egnn_bwd_layout.argtypes = [i] * 7 + [p]
    lib.egnn_bwd_layout.restype = i
    lib.egnn_bwd_edges.argtypes = [p] * 6
    lib.egnn_bwd_edges.restype = i
    lib.egnn_bwd_reduce.argtypes = [p] * 5
    lib.egnn_bwd_reduce.restype = i
    return lib


def _bwd_library() -> ctypes.CDLL:
    return _bwd_load(PROFILE_BUILD)


def launch_grid(name: str, bsz: int, n: int, h: int,
                n_rows: Optional[int] = None,
                compute_dtype: str = "float32") -> tuple:
    """(blocks, rows per block) of the launch that wrapper ``name`` makes
    at these sizes, as the library picks them for this card."""
    rows = _clamp_rows(n, n_rows)
    n_sets = 2 if name == "edge_vector_reduce_pair" else 1
    entry = "egnn_rows_per_block" + (
        "_bf16" if _is_bf16(compute_dtype) else "")
    per_block = getattr(_library(), entry)(
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


def read_bwd_profile() -> dict:
    """``read_profile`` of the backward (``PROFILE_BWD_FIELDS``)."""
    buf = (ctypes.c_ulonglong * len(PROFILE_BWD_FIELDS))()
    err = _bwd_load(True).egnn_bwd_read_profile(buf)
    if err != 0:
        raise RuntimeError(f"read_bwd_profile: CUDA error {err}")
    return {k: int(v) for k, v in zip(PROFILE_BWD_FIELDS, buf)}


def _launch(name: str, device: torch.device, entry, *args) -> None:
    """Call a C entry on the device's current stream; raise on its error."""
    if device.index == torch.cuda.current_device():
        err = entry(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = entry(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (error {err})")


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


def _is_bf16(compute_dtype: str) -> bool:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    return compute_dtype == "bfloat16"


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


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


# k of the A slot s (0..15) inside a k-step of 16 in the bf16 kernel:
# thread t computes k = 4t..4t+3 and packs k = 4t, 4t+1 into slots 2t, 2t+1
# and k = 4t+2, 4t+3 into slots 2t+8, 2t+9
_BF16_SLOT_K = [4 * (s % 8 // 2) + 2 * (s // 8) + s % 2 for s in range(16)]


def pack_w2_bf16(w2: torch.Tensor) -> torch.Tensor:
    """W2 [H, H] as the bf16 kernel's ``wgmma`` reads it from shared
    memory: [H/64, H, 64] bf16, K-major with the 128-byte swizzle.  Slab
    ``s`` holds k = 64s..64s+63; its row ``n`` holds those 64 values of
    column n as eight 16-byte groups, k-step ``q`` = 0..3 of the slab in
    groups 2q (slots 0-7) and 2q+1 (slots 8-15), and group ``j`` is stored
    at position j ^ (n % 8).  Slot ``i`` of a k-step holds k =
    ``_BF16_SLOT_K[i]`` of it, the k order of the A fragments."""
    h = w2.shape[0]
    k = torch.arange(h).reshape(h // 16, 16)
    k = (k[:, :1] + torch.tensor(_BF16_SLOT_K)).reshape(h // 64, 8, 8)
    n = torch.arange(h)
    # stored group position -> logical group: j = pos ^ (n % 8)
    group = torch.arange(8)[None, :] ^ (n % 8)[:, None]          # [n, pos]
    src = k[:, group]                                   # [slab, n, pos, 8]
    w = w2.to(torch.bfloat16)
    return w[src, n[None, :, None, None]].reshape(h // 64, h, 64).contiguous()


# (data_ptr, layout) -> (weak reference to the weight, its version, its
# packed form).  The weights are constant over a sampling run, so each
# is packed once; a training step packs each anew after the update.
_SPLIT_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_SPLIT_CACHE_SIZE = 64


def _packed(w2: torch.Tensor, layout: str) -> torch.Tensor:
    """``pack_w2`` of ``w2`` (layout "w2") or of its transpose ("w2t"), or
    ``pack_w2_bf16`` of it ("bf16"), cached per weight tensor.
    An entry holds only for the very tensor object it was made from and for
    its version counter, so a weight updated in place, or another tensor
    that came to lie at the same address, is split anew.  The key is W2
    itself, also for the transpose: a transposed copy has no stable
    address."""
    key = (w2.data_ptr(), layout)
    hit = _SPLIT_CACHE.get(key)
    if hit is not None and hit[0]() is w2 and hit[1] == w2._version:
        return hit[2]
    w = w2.detach()
    split = {"w2": pack_w2, "w2t": lambda v: pack_w2(v.t()),
             "bf16": pack_w2_bf16}[layout](w)
    _SPLIT_CACHE[key] = (weakref.ref(w2), w2._version, split)
    _SPLIT_CACHE.move_to_end(key)
    while len(_SPLIT_CACHE) > _SPLIT_CACHE_SIZE:
        _SPLIT_CACHE.popitem(last=False)
    return split


def split_w2(w2: torch.Tensor) -> torch.Tensor:
    """``pack_w2(w2)``, cached per weight tensor (see ``_packed``)."""
    return _packed(w2, "w2")


def split_w2t(w2: torch.Tensor) -> torch.Tensor:
    """``pack_w2(w2.t())``, the B operand of du @ W2^T in the fp32
    backward, cached per weight tensor W2 (see ``_packed``)."""
    return _packed(w2, "w2t")


def pack_w2_bf16_cached(w2: torch.Tensor) -> torch.Tensor:
    """``pack_w2_bf16(w2)``, cached per weight tensor (see ``_packed``)."""
    return _packed(w2, "bf16")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _row_chunk(bsz: int, n: int, h: int,
               elems: int = _PLAIN_CHUNK_ELEMS) -> int:
    return max(1, min(n, elems // max(1, bsz * n * h)))


def _edge_pre(a, b, d2c, d2i, we):
    """u1 = a_i + b_j + d2c*we0 + d2i*we1 for a row chunk: a [B, T, H],
    d2c/d2i [B, T, N] -> [B, T, N, H]."""
    return (a[:, :, None, :] + b[:, None, :, :]
            + d2c[..., None] * we[0] + d2i[..., None] * we[1])


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def rounding(compute_dtype: str):
    """The rounding to the compute dtype: bf16 (nearest even, the dtype
    kept) or none."""
    return bf16_round if _is_bf16(compute_dtype) else _identity


def _edge_messages(a, b, d2c, d2i, we, w2r, b2, rnd=_identity):
    """m = silu(rnd(silu(u1)) @ w2r + b2) for a row chunk -> [B, T, N, H];
    w2r is W2 as the call rounded it, once (a weight rounded per chunk
    would have its gradient rounded per chunk, and so depend on the
    chunking)."""
    return F.silu(rnd(F.silu(_edge_pre(a, b, d2c, d2i, we))) @ w2r + b2)


def _direction(xr, xc, center, cross: bool, norm_constant: float):
    """v_ij of rows xr [B, T, 1, 3] against columns xc [B, 1, N, 3]: the
    normalised difference, or the normalised cross product about center
    [B, 1, 3].  Returns (v [B, T, N, 3], back), where back maps the
    gradient of v to those of x_i and x_j.  The cross norm has no
    gradient where the cross product is 0 (self-edges), as in the JAX
    dense path's double ``where``; its value is unchanged."""
    if cross:
        ctr = center[:, :, None, :]
        p, q = xr - ctr, xc - ctr
        v = torch.linalg.cross(p, q)
        n2 = (v * v).sum(-1, keepdim=True)
        pos = n2 > 0
        one = torch.ones_like(n2)
        norm = torch.where(pos, torch.sqrt(torch.where(pos, n2, one)),
                           torch.zeros_like(n2))
        den = norm + norm_constant

        def back(gv):
            k = torch.where(pos, (gv * v).sum(-1, keepdim=True)
                            / (den * den * torch.where(pos, norm, one)),
                            torch.zeros_like(n2))
            dv = gv / den - k * v
            return (torch.linalg.cross(q.expand_as(dv), dv),
                    torch.linalg.cross(dv, p.expand_as(dv)))
        return v / den, back
    d = xr - xc
    r = torch.sqrt((d * d).sum(-1, keepdim=True) + 1e-8)
    den = r + norm_constant

    def back(gv):
        dd = gv / den - (gv * d).sum(-1, keepdim=True) / (den * den * r) * d
        return dd, -dd
    return d / den, back


def gcl_messages_plain(a, b, d2c, d2i, adj, we, w2, b2, watt, batt=None,
                       attention: bool = True, norm_factor: float = 100.0,
                       compute_dtype: str = "float32"):
    rnd = rounding(compute_dtype)
    w2r, wattr = rnd(w2), rnd(watt)
    bsz, n, h = a.shape
    out = torch.empty((bsz, n, h), dtype=a.dtype, device=a.device)
    step = _row_chunk(bsz, n, h)
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        m = _edge_messages(a[:, i0:i1], b, d2c[:, i0:i1], d2i[:, i0:i1],
                           we, w2r, b2, rnd)
        if attention:
            att = rnd(m) @ wattr
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
                             n_rows: Optional[int] = None,
                             compute_dtype: str = "float32"):
    rnd = rounding(compute_dtype)
    w2r, woutr = rnd(w2), rnd(wout)
    bsz, n, h = a.shape
    rows = _clamp_rows(n, n_rows)
    out = torch.zeros((bsz, n, 3), dtype=a.dtype, device=a.device)
    step = _row_chunk(bsz, n, h)
    for i0 in range(0, rows, step):
        i1 = min(rows, i0 + step)
        m = _edge_messages(a[:, i0:i1], b, d2c[:, i0:i1], d2i[:, i0:i1],
                           we, w2r, b2, rnd)
        phi = (rnd(m) @ woutr)[..., 0]                 # [B, T, N]
        if tanh:
            phi = torch.tanh(phi) * coords_range
        w = phi * adj[:, i0:i1]
        v, _ = _direction(x[:, i0:i1, None, :], x[:, None, :, :], center,
                          cross, norm_constant)
        out[:, i0:i1] = (v * w[..., None]).sum(dim=2) / norm_factor
    return out


def edge_vector_reduce_pair_plain(a, b, d2c, d2i, adj, x, center, we, w2, b2,
                                  wout, tanh: bool = True,
                                  coords_range: float = 15.0,
                                  norm_constant: float = 1.0,
                                  norm_factor: float = 100.0,
                                  n_rows: Optional[int] = None,
                                  compute_dtype: str = "float32"):
    parts = [edge_vector_reduce_plain(
        a[s], b[s], d2c, d2i, adj, x, center, we[s], w2[s], b2[s], wout[s],
        tanh, coords_range, norm_constant, bool(s), norm_factor, n_rows,
        compute_dtype) for s in (0, 1)]
    return parts[0] + parts[1]


# ---------------------------------------------------------------------------
# plain backward: the formulas the backward kernels compute
# ---------------------------------------------------------------------------

def _dsilu(v: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(v)
    return s * (1.0 + v * (1.0 - s))


def _zeros(*tensors):
    return [torch.zeros_like(t) for t in tensors]


def _chain_backward(dm, u1, s, u, w2, we, d2c, d2i, grads, i0, i1,
                    rnd=_identity):
    """From dm, the gradient of m over a row chunk [B, T, N, H], to the
    chain's inputs: adds into grads = [da, db, dd2c, dd2i, dwe, dw2, db2]
    (dd2c and dd2i rows i0:i1 are written).  s and w2 are the operands of
    the product as the forward rounded them; ``rnd`` rounds the gradient
    of s, as the cast rule does where the forward rounded silu(u1)."""
    da, db, dd2c, dd2i, dwe, dw2, db2 = grads
    h = u.shape[-1]
    du = dm * _dsilu(u)
    db2 += du.sum((0, 1, 2))
    dw2 += s.reshape(-1, h).T @ du.reshape(-1, h)
    dz = rnd(du @ w2.T) * _dsilu(u1)
    da[:, i0:i1] += dz.sum(2)
    db += dz.sum(1)
    dd2c[:, i0:i1] = dz @ we[0]
    dd2i[:, i0:i1] = dz @ we[1]
    dwe[0] += (dz * d2c[..., None]).sum((0, 1, 2))
    dwe[1] += (dz * d2i[..., None]).sum((0, 1, 2))


def _dot_backward(coef, m, wr, rnd=_identity):
    """The VJP of the per-edge dot rnd(m) . wr (wr [H, 1] as the call
    rounded it) for the dot's gradient coef [B, T, N, 1]: the gradient of
    rnd(m), rounded as the cast rule rounds it, and sum coef * rnd(m) over
    the chunk's edges [H, 1], the weight's gradient before its one
    rounding per call."""
    return (rnd(coef * wr[:, 0]),
            (coef * rnd(m)).sum((0, 1, 2))[:, None])


def gcl_messages_backward_plain(gout, a, b, d2c, d2i, adj, we, w2, b2, watt,
                                batt=None, attention: bool = True,
                                norm_factor: float = 100.0,
                                compute_dtype: str = "float32"):
    """The gradients of ``gcl_messages_plain``'s output, given its
    gradient gout [B, N, H], with respect to its arguments, in their
    order: (a, b, d2c, d2i, None for adj, we, w2, b2, watt, batt or
    None).  With g = gout_i * adj_ij / norm_factor per edge:
    dm = g * gate + (g . m) * gate * (1 - gate) * watt, then the chain.
    Recomputed in row chunks; nothing of [B, N, N, H] size is kept.

    In bf16 (rnd the rounding, ' a rounded value): s' = rnd(silu(u1)),
    W2' and watt' rounded once; the gate reads rnd(m) . watt'; the
    gradient of rnd(m), datt * watt', is rounded before it joins dm, and
    that of s', du W2'^T, before silu'(u1); dW2 = sum s'^T du and dwatt =
    sum datt rnd(m) are fp32 sums over the call, rounded once at the end.
    """
    rnd = rounding(compute_dtype)
    w2r, wattr = rnd(w2), rnd(watt)
    bsz, n, h = a.shape
    da, db, dd2c, dd2i, dwe, dw2, db2, dwatt = _zeros(a, b, d2c, d2i, we, w2,
                                                      b2, watt)
    dbatt = None if batt is None else torch.zeros_like(batt)
    grads = [da, db, dd2c, dd2i, dwe, dw2, db2]
    step = _row_chunk(bsz, n, h, _PLAIN_CHUNK_ELEMS // 8)
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        d2c_c, d2i_c = d2c[:, i0:i1], d2i[:, i0:i1]
        u1 = _edge_pre(a[:, i0:i1], b, d2c_c, d2i_c, we)
        s = rnd(F.silu(u1))
        u = s @ w2r + b2
        m = F.silu(u)
        g = gout[:, i0:i1, None, :] * (adj[:, i0:i1, :, None] / norm_factor)
        if attention:
            mr = rnd(m)
            att = mr @ wattr
            if batt is not None:
                att = att + batt
            gate = torch.sigmoid(att)
            datt = (g * m).sum(-1, keepdim=True) * gate * (1.0 - gate)
            dmr, dw = _dot_backward(datt, m, wattr, rnd)
            dm = g * gate + dmr
            dwatt += dw
            if dbatt is not None:
                dbatt += datt.sum()
        else:
            dm = g
        _chain_backward(dm, u1, s, u, w2r, we, d2c_c, d2i_c, grads, i0, i1,
                        rnd)
    return da, db, dd2c, dd2i, None, dwe, rnd(dw2), db2, rnd(dwatt), dbatt


def edge_vector_reduce_backward_plain(gout, a, b, d2c, d2i, adj, x, center,
                                      we, w2, b2, wout, tanh: bool = True,
                                      coords_range: float = 15.0,
                                      norm_constant: float = 1.0,
                                      cross: bool = False,
                                      norm_factor: float = 100.0,
                                      n_rows: Optional[int] = None,
                                      compute_dtype: str = "float32"):
    """The gradients of ``edge_vector_reduce_plain``'s output, given its
    gradient gout [B, N, 3], with respect to its arguments, in their
    order: (a, b, d2c, d2i, None for adj, x, center, we, w2, b2, wout).
    Per edge: dphi = adj / norm_factor * (gout_i . v_ij), through the
    tanh to dm = dphi' * wout, then the chain; and the direction's own
    gradient, w * gout_i with w = adj * phi / norm_factor, to x_i, x_j
    and (cross) the centre.  Rows at or beyond n_rows give nothing.  In
    bf16 the rounding points of ``gcl_messages_backward_plain``, with phi
    reading rnd(m) . wout', dm = rnd(dphi' wout') and dwout = sum dphi'
    rnd(m) rounded once."""
    rnd = rounding(compute_dtype)
    w2r, woutr = rnd(w2), rnd(wout)
    bsz, n, h = a.shape
    rows = _clamp_rows(n, n_rows)
    da, db, dd2c, dd2i, dx, dcenter, dwe, dw2, db2, dwout = _zeros(
        a, b, d2c, d2i, x, center, we, w2, b2, wout)
    grads = [da, db, dd2c, dd2i, dwe, dw2, db2]
    step = _row_chunk(bsz, n, h, _PLAIN_CHUNK_ELEMS // 8)
    for i0 in range(0, rows, step):
        i1 = min(rows, i0 + step)
        d2c_c, d2i_c = d2c[:, i0:i1], d2i[:, i0:i1]
        u1 = _edge_pre(a[:, i0:i1], b, d2c_c, d2i_c, we)
        s = rnd(F.silu(u1))
        u = s @ w2r + b2
        m = F.silu(u)
        dot = (rnd(m) @ woutr)[..., 0]                 # [B, T, N]
        phi = torch.tanh(dot) * coords_range if tanh else dot
        v, back = _direction(x[:, i0:i1, None, :], x[:, None, :, :], center,
                             cross, norm_constant)
        g = gout[:, i0:i1, None, :]                    # [B, T, 1, 3]
        av = adj[:, i0:i1] / norm_factor
        dphi = av * (g * v).sum(-1)
        if tanh:
            dphi = dphi * coords_range * (1.0 - torch.tanh(dot) ** 2)
        dm, dw = _dot_backward(dphi[..., None], m, woutr, rnd)
        dwout += dw
        gp, gq = back((av * phi)[..., None] * g)
        dx[:, i0:i1] += gp.sum(2)
        dx += gq.sum(1)
        if cross:
            dcenter -= (gp.sum((1, 2)) + gq.sum((1, 2)))[:, None, :]
        _chain_backward(dm, u1, s, u, w2r, we, d2c_c, d2i_c, grads, i0, i1,
                        rnd)
    return (da, db, dd2c, dd2i, None, dx, dcenter, dwe, rnd(dw2), db2,
            rnd(dwout))


# argument positions of the vector reduction shared by both sets
_VEC_SHARED = (2, 3, 5, 6)


def edge_vector_reduce_pair_backward_plain(gout, a, b, d2c, d2i, adj, x,
                                           center, we, w2, b2, wout,
                                           tanh: bool = True,
                                           coords_range: float = 15.0,
                                           norm_constant: float = 1.0,
                                           norm_factor: float = 100.0,
                                           n_rows: Optional[int] = None,
                                           compute_dtype: str = "float32"):
    """``edge_vector_reduce_backward_plain`` of the pair: the per-set
    gradients (a, b, we, w2, b2, wout) as pairs, the shared ones (d2c,
    d2i, x, center) summed over the two sets."""
    parts = [edge_vector_reduce_backward_plain(
        gout, a[s], b[s], d2c, d2i, adj, x, center, we[s], w2[s], b2[s],
        wout[s], tanh, coords_range, norm_constant, bool(s), norm_factor,
        n_rows, compute_dtype) for s in (0, 1)]
    return tuple(None if p0 is None else
                 (p0 + p1 if i in _VEC_SHARED else (p0, p1))
                 for i, (p0, p1) in enumerate(zip(*parts)))



# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _ptrs(*tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))


def _packed_w2(w2: torch.Tensor, bf16: bool) -> torch.Tensor:
    """W2 as the kernel variant reads it, cached per weight tensor."""
    return pack_w2_bf16_cached(w2) if bf16 else split_w2(w2)


def _gcl_messages_cuda(a, b, d2c, d2i, adj, we, w2, b2, watt, batt,
                       attention, norm_factor, bf16=False):
    bsz, n, h = a.shape
    _hidden_ok("gcl_messages", h, n)
    if batt is None:
        batt = torch.zeros((1,), dtype=torch.float32, device=a.device)
    ptr = _check_cuda("gcl_messages",
                      dict(a=a, b=b, d2c=d2c, d2i=d2i, adj=adj, we=we, w2=w2,
                           b2=b2, watt=watt, batt=batt), _shapes(bsz, n, h))
    w2p = _packed_w2(w2, bf16)
    ptr["w2"] = w2p.data_ptr()
    out = torch.empty((bsz, n, h), dtype=torch.float32, device=a.device)
    suffix = "_bf16" if bf16 else ""
    _launch("gcl_messages", a.device,
            getattr(_library(), "egnn_gcl_messages" + suffix),
            *(ptr[k] for k in ("a", "b", "d2c", "d2i", "adj", "we", "w2",
                               "b2", "watt", "batt")),
            out.data_ptr(), bsz, n, h, int(bool(attention)),
            float(norm_factor))
    _count("gcl_messages", bf16)
    return out


def _edge_vector_reduce_cuda(a, b, d2c, d2i, adj, x, center, we, w2, b2,
                             wout, tanh, coords_range, norm_constant, cross,
                             norm_factor, n_rows, bf16=False):
    bsz, n, h = a.shape
    _hidden_ok("edge_vector_reduce", h, n)
    ptr = _check_cuda("edge_vector_reduce",
                      dict(a=a, b=b, d2c=d2c, d2i=d2i, adj=adj, x=x,
                           center=center, we=we, w2=w2, b2=b2, wout=wout),
                      _shapes(bsz, n, h))
    w2p = _packed_w2(w2, bf16)
    ptr["w2"] = w2p.data_ptr()
    rows = _clamp_rows(n, n_rows)
    out = _vec_output((bsz, n, 3), rows, n, a.device)
    if rows == 0:
        return out
    suffix = "_bf16" if bf16 else ""
    _launch("edge_vector_reduce", a.device,
            getattr(_library(), "egnn_edge_vector_reduce" + suffix),
            *(ptr[k] for k in ("a", "b", "d2c", "d2i", "adj", "x", "center",
                               "we", "w2", "b2", "wout")),
            out.data_ptr(), bsz, n, h, rows, int(bool(tanh)),
            float(coords_range), float(norm_constant), int(bool(cross)),
            float(norm_factor))
    _count("edge_vector_reduce", bf16)
    return out


def _edge_vector_reduce_pair_cuda(a, b, d2c, d2i, adj, x, center, we, w2, b2,
                                  wout, tanh, coords_range, norm_constant,
                                  norm_factor, n_rows, bf16=False):
    name = "edge_vector_reduce_pair"
    bsz, n, h = a[0].shape
    _hidden_ok(name, h, n)
    shapes = _shapes(bsz, n, h)
    # the shared tensors are checked with the first set
    shared = [dict(d2c=d2c, d2i=d2i, adj=adj, x=x, center=center), {}]
    ptrs = [_check_cuda(f"{name}[{s}]",
                        dict(a=a[s], b=b[s], we=we[s], w2=w2[s], b2=b2[s],
                             wout=wout[s], **shared[s]), shapes)
            for s in (0, 1)]
    # the packed weights, held until the launch is queued
    packed = [_packed_w2(w2[s], bf16) for s in (0, 1)]
    for s in (0, 1):
        ptrs[s]["w2"] = packed[s].data_ptr()
    if a[1].device != a[0].device:
        raise ValueError(f"{name}: the two sets are on different devices")
    rows = _clamp_rows(n, n_rows)
    out = _vec_output((2, bsz, n, 3), rows, n, a[0].device)
    if rows == 0:
        return out[0]
    suffix = "_bf16" if bf16 else ""
    _launch(name, a[0].device,
            getattr(_library(), "egnn_edge_vector_reduce_pair" + suffix),
            *(ptrs[s][k] for s in (0, 1)
              for k in ("a", "b", "we", "w2", "b2", "wout")),
            *(ptrs[0][k] for k in ("d2c", "d2i", "adj", "x", "center")),
            out.data_ptr(), bsz, n, h, rows, int(bool(tanh)),
            float(coords_range), float(norm_constant), float(norm_factor))
    _count("edge_vector_reduce", bf16)
    return out[0] + out[1]


def _bwd_layout(bsz: int, n: int, h: int, rows: int, n_sets: int,
                vec: bool, bf16: bool = False) -> tuple:
    """(rows per block, blocks per batch element and set, floats per
    block's partial record) of a backward launch at these sizes (``vec``:
    of ``edge_vector_reduce``, else of ``gcl_messages``; ``bf16``: of the
    bf16 backward)."""
    out = (ctypes.c_int * 3)()
    err = _bwd_library().egnn_bwd_layout(bsz, n, h, rows, n_sets, int(vec),
                                         int(bf16), out)
    if err != 0:
        raise ValueError(f"backward kernels: unsupported sizes B={bsz} "
                         f"N={n} H={h} rows={rows}")
    return tuple(out)


def bwd_launch_grid(name: str, bsz: int, n: int, h: int,
                    n_rows: Optional[int] = None,
                    compute_dtype: str = "float32") -> tuple:
    """(blocks, rows per block) of the first of the two launches that the
    backward of wrapper ``name`` makes at these sizes, in the compute
    dtype's kernel (``bwd_rows_per_block`` mirrors the choice)."""
    rows = _clamp_rows(n, n_rows)
    if rows == 0:
        return 0, 0
    n_sets = 2 if name == "edge_vector_reduce_pair" else 1
    per_block, per_batch, _ = _bwd_layout(bsz, n, h, rows, n_sets,
                                          name != "gcl_messages",
                                          _is_bf16(compute_dtype))
    return per_batch * bsz * n_sets, per_block


# the bf16 backward's shared memory (edge_chain_bwd_wgmma in
# csrc/egnn_edge_bwd.cu), mirrored: 1024 bytes of alignment, W2' whole (a
# ring of two 64-k slabs at H = 256), s' and du's three bf16 parts of a
# 64-edge pass, two barriers, fp32 arrays (at H = 128 the block's dW2,
# four weight vectors, the warpgroups' row dots, the pass's edges); per
# owned row a and da, and gcl's output gradient row or the vector kernel's
# gout and dx rows; the list of R * N candidate pairs
_BWD_SMEM_LIMIT, _BWD_R_MAX, _BWD_SMS, _BWD_PE, _DU_PARTS = (232448, 16, 132,
                                                              64, 3)


def bwd_bf16_smem_bytes(h: int, vec: bool, rows: int, n: int) -> int:
    """The bytes of shared memory a bf16 backward block of ``rows`` rows
    takes at these sizes."""
    slab = 128 * h
    held = 2 if h == 256 else h // 64
    floats = (h * h if h == 128 else 0) + 4 * h + 4 * _BWD_PE + 3 * _BWD_PE \
        + (9 * _BWD_PE if vec else 0) + 4 * _BWD_PE
    fixed = (1024 + held * slab + (1 + _DU_PARTS) * (h // 64) * 128 * _BWD_PE
             + 16 + 4 * floats)
    return fixed + 4 * rows * (2 * h + (8 if vec else h) + n)


def bwd_rows_per_block(bsz: int, n: int, h: int, rows: int, n_sets: int,
                       vec: bool) -> int:
    """The bf16 backward's rows per block: about one block per SM, at
    most 16 rows, fewer where shared memory would not hold them (0 where
    not one row fits)."""
    r = max(1, min(-(-bsz * rows * n_sets // _BWD_SMS), _BWD_R_MAX, rows))
    while r > 1 and bwd_bf16_smem_bytes(h, vec, r, n) > _BWD_SMEM_LIMIT:
        r -= 1
    return r if bwd_bf16_smem_bytes(h, vec, r, n) <= _BWD_SMEM_LIMIT else 0


def _bwd_packed(w2: torch.Tensor, bf16: bool) -> tuple:
    """(W2, W2^T) as the backward kernel reads them: fp32 both split and
    packed for its ring (``split_w2``, ``split_w2t``); bf16 W2 as the bf16
    forward reads it (``pack_w2_bf16_cached``), and no transpose: the
    kernel reads the same copy transposed."""
    if bf16:
        return pack_w2_bf16_cached(w2), None
    return split_w2(w2), split_w2t(w2)


def _gcl_messages_backward_cuda(gout, a, b, d2c, d2i, adj, we, w2, b2, watt,
                                batt, attention, norm_factor, needs,
                                bf16=False):
    """Two launches: every block's edges, then the fixed-order sums of
    the blocks' partial records.  Gradients in argument order, None where
    ``needs`` says none is wanted (d2c and d2i are then not written).
    ``bf16``: the backward of the bf16 forward (W2 as ``pack_w2_bf16``
    lays it out, the bf16 forward's cached tensor)."""
    bsz, n, h = a.shape
    dev = a.device
    if gout.dtype != torch.float32 or gout.device != dev:
        raise ValueError("gcl_messages backward: the output gradient must "
                         "be float32 on the inputs' device")
    lib = _bwd_library()
    _, per_batch, rec = _bwd_layout(bsz, n, h, n, 1, False, bf16)
    part = torch.empty(bsz * per_batch * rec, dtype=torch.float32,
                       device=dev)
    gout = gout.contiguous()
    da, db, dwe, dw2, db2, dwatt = (torch.empty_like(t)
                                    for t in (a, b, we, w2, b2, watt))
    dd2c = torch.zeros_like(d2c) if needs[2] else None
    dd2i = torch.zeros_like(d2i) if needs[3] else None
    batt_t = batt if batt is not None else torch.zeros(
        (1,), dtype=torch.float32, device=dev)
    dbatt = torch.empty_like(batt_t)
    ints = (ctypes.c_int * 9)(bsz, n, h, n, 1, 0, int(bool(attention)), 0,
                              int(bf16))
    floats = (ctypes.c_float * 3)(0.0, 0.0, float(norm_factor))
    # W2 packed (fp32: W2 and W2^T split for the ring), held until both
    # launches are queued
    w2p, w2tp = _bwd_packed(w2, bf16)
    _launch("gcl_messages backward", dev, lib.egnn_bwd_edges,
            _ptrs(a, b, we, w2p, w2tp, b2, watt, da, dd2c, dd2i),
            _ptrs(*[None] * 10),
            _ptrs(gout, d2c, d2i, adj, None, None, batt_t, part), ints,
            floats)
    _count("gcl_messages_bwd", bf16)
    _launch("gcl_messages backward", dev, lib.egnn_bwd_reduce,
            _ptrs(dw2, db, db2, dwe, dwatt), _ptrs(*[None] * 5),
            _ptrs(part, None, None, dbatt, None, None), ints)
    _count("gcl_messages_bwd", bf16)
    return da, db, dd2c, dd2i, None, dwe, dw2, db2, dwatt, (
        None if batt is None else dbatt)


def _edge_vector_reduce_backward_cuda(gout, sets, d2c, d2i, adj, x, center,
                                      tanh, coords_range, norm_constant,
                                      cross, norm_factor, n_rows, needs,
                                      bf16=False):
    """``sets``: one or two (a, b, we, w2, b2, wout); with two, the first
    is the difference and the second the cross direction.  Returns
    (per-set gradients [(da, db, dwe, dw2, db2, dwout)], dd2c, dd2i, dx,
    dcenter); dd2c / dd2i None unless ``needs`` = (d2c, d2i) asks.
    ``bf16``: the backward of the bf16 forward."""
    a0 = sets[0][0]
    bsz, n, h = a0.shape
    dev = a0.device
    n_sets = len(sets)
    rows = _clamp_rows(n, n_rows)
    planes = [torch.zeros((n_sets,) + tuple(d2c.shape), dtype=torch.float32,
                          device=dev) if want else None for want in needs]
    if gout.dtype != torch.float32 or gout.device != dev:
        raise ValueError("edge_vector_reduce backward: the output gradient "
                         "must be float32 on the inputs' device")
    dx, dcenter = ((torch.zeros_like if rows == 0 else torch.empty_like)(t)
                   for t in (x, center))
    if rows == 0:
        out = [[torch.zeros_like(t) for t in s] for s in sets]
        return out, *(p if p is None else p[0] for p in planes), dx, dcenter
    lib = _bwd_library()
    _, per_batch, rec = _bwd_layout(bsz, n, h, rows, n_sets, True, bf16)
    part = torch.empty(n_sets * bsz * per_batch * rec, dtype=torch.float32,
                       device=dev)
    # the reduce writes every gradient but da, whose rows >= n_rows stay 0
    out = [[(torch.empty_like if i or rows == n else torch.zeros_like)(t)
            for i, t in enumerate(s)] for s in sets]
    # W2 of each set packed (fp32: W2 and W2^T split for the ring), held
    # until both launches are queued
    packed = [_bwd_packed(st[3], bf16) for st in sets]
    gout = gout.contiguous()
    set_ptrs = [_ptrs(a, b, we, *packed[s], b2, wout, out[s][0],
                      *(p if p is None else p[s] for p in planes))
                for s, (a, b, we, w2, b2, wout) in enumerate(sets)]
    set_ptrs += [_ptrs(*[None] * 10)] * (2 - n_sets)
    # the direction of the first set: its own for one set, the difference
    # for the pair (whose second set is the cross direction)
    ints = (ctypes.c_int * 9)(bsz, n, h, rows, n_sets, 1, int(bool(tanh)),
                              int(bool(cross)) if n_sets == 1 else 0,
                              int(bf16))
    floats = (ctypes.c_float * 3)(float(coords_range), float(norm_constant),
                                  float(norm_factor))
    name = "edge_vector_reduce backward"
    _launch(name, dev, lib.egnn_bwd_edges, *set_ptrs,
            _ptrs(gout, d2c, d2i, adj, x, center, None, part),
            ints, floats)
    _count("edge_vector_reduce_bwd", bf16)
    red = [_ptrs(o[3], o[1], o[4], o[2], o[5]) for o in out]
    red += [_ptrs(*[None] * 5)] * (2 - n_sets)
    _launch(name, dev, lib.egnn_bwd_reduce, *red,
            _ptrs(part, dx, dcenter, None, *planes), ints)
    _count("edge_vector_reduce_bwd", bf16)
    return out, *(p if p is None else p[0] for p in planes), dx, dcenter


# ---------------------------------------------------------------------------
# autograd Functions: the forward and backward of each wrapper
# ---------------------------------------------------------------------------

def _gcl_forward(a, b, d2c, d2i, adj, we, w2, b2, watt, batt, attention,
                 norm_factor, compute_dtype):
    if a.device.type == "cpu":
        return gcl_messages_plain(a, b, d2c, d2i, adj, we, w2, b2, watt,
                                  batt, attention, norm_factor, compute_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"gcl_messages: unsupported device {a.device}")
    return _gcl_messages_cuda(a, b, d2c, d2i, adj, we, w2, b2, watt, batt,
                              attention, norm_factor, _is_bf16(compute_dtype))


class _GclMessages(torch.autograd.Function):
    """``gcl_messages`` with its backward, in either compute dtype.  Saves
    only its inputs; the backward recomputes the chain (the CUDA kernels
    on the card, the plain backward on the CPU)."""

    @staticmethod
    def forward(ctx, a, b, d2c, d2i, adj, we, w2, b2, watt, batt, attention,
                norm_factor, compute_dtype):
        ctx.save_for_backward(a, b, d2c, d2i, adj, we, w2, b2, watt, batt)
        ctx.opts = (attention, norm_factor, compute_dtype)
        return _gcl_forward(a, b, d2c, d2i, adj, we, w2, b2, watt, batt,
                            *ctx.opts)

    @staticmethod
    def backward(ctx, gout):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:10]
        attention, norm_factor, compute_dtype = ctx.opts
        with annotate("kernels.gcl_messages_bwd"):
            if saved[0].device.type == "cpu":
                grads = gcl_messages_backward_plain(gout, *saved, *ctx.opts)
            else:
                grads = _gcl_messages_backward_cuda(
                    gout, *saved, attention, norm_factor, needs,
                    _is_bf16(compute_dtype))
        return (*(g if want else None for g, want in zip(grads, needs)),
                None, None, None)


def _vec_forward(opts, d2c, d2i, adj, x, center, sets):
    tanh, coords_range, norm_constant, cross, norm_factor, n_rows, \
        compute_dtype = opts
    a = sets[0][0]
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"edge_vector_reduce: unsupported device {a.device}")
    cpu = a.device.type == "cpu"
    dtype = dict(compute_dtype=compute_dtype) if cpu else dict(
        bf16=_is_bf16(compute_dtype))
    if len(sets) == 1:
        fn = edge_vector_reduce_plain if cpu else _edge_vector_reduce_cuda
        a, b, we, w2, b2, wout = sets[0]
        return fn(a, b, d2c, d2i, adj, x, center, we, w2, b2, wout, tanh,
                  coords_range, norm_constant, cross, norm_factor, n_rows,
                  **dtype)
    fn = (edge_vector_reduce_pair_plain if cpu
          else _edge_vector_reduce_pair_cuda)
    a, b, we, w2, b2, wout = zip(*sets)
    return fn(a, b, d2c, d2i, adj, x, center, we, w2, b2, wout, tanh,
              coords_range, norm_constant, norm_factor, n_rows, **dtype)


class _EdgeVectorReduce(torch.autograd.Function):
    """``edge_vector_reduce`` (one weight set) and ``_pair`` (two) with
    their backward.  Arguments: the options (tanh, coords_range,
    norm_constant, cross, norm_factor, n_rows, compute_dtype), the shared
    d2c, d2i, adj, x, center, then six tensors per set (a, b, we, w2, b2,
    wout).  Saves only its inputs."""

    @staticmethod
    def forward(ctx, opts, d2c, d2i, adj, x, center, *flat):
        sets = [flat[i:i + 6] for i in range(0, len(flat), 6)]
        ctx.save_for_backward(d2c, d2i, adj, x, center, *flat)
        ctx.opts = opts
        return _vec_forward(opts, d2c, d2i, adj, x, center, sets)

    @staticmethod
    def backward(ctx, gout):
        with annotate("kernels.edge_vector_reduce_bwd"):
            d2c, d2i, adj, x, center, *flat = ctx.saved_tensors
            sets = [flat[i:i + 6] for i in range(0, len(flat), 6)]
            tanh, coords_range, norm_constant, cross, norm_factor, n_rows, \
                compute_dtype = ctx.opts
            needs = ctx.needs_input_grad
            if d2c.device.type == "cpu":
                per_set, shared = [], None
                for s, (a, b, we, w2, b2, wout) in enumerate(sets):
                    g = edge_vector_reduce_backward_plain(
                        gout, a, b, d2c, d2i, adj, x, center, we, w2, b2, wout,
                        tanh, coords_range, norm_constant,
                        bool(s) if len(sets) == 2 else cross, norm_factor,
                        n_rows, compute_dtype)
                    per_set.append((g[0], g[1], g[7], g[8], g[9], g[10]))
                    parts = (g[2], g[3], g[5], g[6])
                    shared = parts if shared is None else tuple(
                        p + q for p, q in zip(shared, parts))
                dd2c, dd2i, dx, dcenter = shared
            else:
                per_set, dd2c, dd2i, dx, dcenter = \
                    _edge_vector_reduce_backward_cuda(
                        gout, sets, d2c, d2i, adj, x, center, tanh,
                        coords_range, norm_constant, cross, norm_factor,
                        n_rows, needs[1:3], _is_bf16(compute_dtype))
            flat_grads = [g for s in per_set for g in s]
            out = [None, dd2c, dd2i, None, dx, dcenter, *flat_grads]
            return tuple(g if want else None for g, want in zip(out, needs))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def gcl_messages(a, b, d2c, d2i, adj, we, w2, b2, watt, batt=None,
                 attention: bool = True, norm_factor: float = 100.0,
                 compute_dtype: str = "float32"):
    """a, b: [B, N, H] node projections (edge_dst bias folded into b);
    d2c/d2i/adj: [B, N, N]; we: [2, H]; w2: [H, H]; b2: [H]; watt: [H, 1];
    batt: [1] or None.  Returns [B, N, H] float32; differentiable with
    respect to every argument but adj, in either compute dtype."""
    _is_bf16(compute_dtype)
    args = (a, b, d2c, d2i, adj, we, w2, b2, watt, batt, attention,
            norm_factor, compute_dtype)
    with annotate("kernels.gcl_messages"):
        if torch.is_grad_enabled():
            return _GclMessages.apply(*args)
        return _gcl_forward(*args)


def edge_vector_reduce(a, b, d2c, d2i, adj, x, center, we, w2, b2, wout,
                       tanh: bool = True, coords_range: float = 15.0,
                       norm_constant: float = 1.0, cross: bool = False,
                       norm_factor: float = 100.0,
                       n_rows: Optional[int] = None,
                       compute_dtype: str = "float32"):
    """Returns [B, N, 3] = sum_j adj_ij * phi_ij * v_ij / norm_factor.

    x: [B, N, 3]; center: [B, 1, 3] (joint COM, used when cross=True);
    n_rows: only rows < n_rows are computed, the rest are zero."""
    _is_bf16(compute_dtype)
    opts = (tanh, coords_range, norm_constant, cross, norm_factor, n_rows,
            compute_dtype)
    with annotate("kernels.edge_vector_reduce"):
        if torch.is_grad_enabled():
            return _EdgeVectorReduce.apply(opts, d2c, d2i, adj, x, center, a,
                                           b, we, w2, b2, wout)
        return _vec_forward(opts, d2c, d2i, adj, x, center,
                            [(a, b, we, w2, b2, wout)])


def edge_vector_reduce_pair(a: Sequence[torch.Tensor],
                            b: Sequence[torch.Tensor], d2c, d2i, adj, x,
                            center, we: Sequence[torch.Tensor],
                            w2: Sequence[torch.Tensor],
                            b2: Sequence[torch.Tensor],
                            wout: Sequence[torch.Tensor], tanh: bool = True,
                            coords_range: float = 15.0,
                            norm_constant: float = 1.0,
                            norm_factor: float = 100.0,
                            n_rows: Optional[int] = None,
                            compute_dtype: str = "float32"):
    """``edge_vector_reduce(..., cross=False)`` with the first weight set
    plus ``edge_vector_reduce(..., cross=True)`` with the second, over the
    same graph, in one launch.  ``a``, ``b``, ``we``, ``w2``, ``b2`` and
    ``wout`` are pairs of tensors (taken as they are: stacking them would
    cost more launches than the pair saves).  Returns [B, N, 3]."""
    name = "edge_vector_reduce_pair"
    for key, pair in dict(a=a, b=b, we=we, w2=w2, b2=b2, wout=wout).items():
        if len(pair) != 2:
            raise ValueError(f"{name}: {key} must be a pair of tensors")
    _is_bf16(compute_dtype)
    opts = (tanh, coords_range, norm_constant, True, norm_factor, n_rows,
            compute_dtype)
    sets = [(a[s], b[s], we[s], w2[s], b2[s], wout[s]) for s in (0, 1)]
    with annotate("kernels.edge_vector_reduce_pair"):
        if torch.is_grad_enabled():
            return _EdgeVectorReduce.apply(opts, d2c, d2i, adj, x, center,
                                           *sets[0], *sets[1])
        return _vec_forward(opts, d2c, d2i, adj, x, center, sets)
