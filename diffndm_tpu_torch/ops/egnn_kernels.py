"""The EGNN edge-chain kernels: wrappers, plain versions, build.

Two functions carry nearly all of the denoiser's device work, and each
is a hand-written CUDA kernel for Hopper (``csrc/egnn_edge.cu``):

- ``gcl_messages``: out_i = sum_j adj_ij * m_ij / norm_factor, where
  m_ij = silu(silu(a_i + b_j + d2c_ij*we0 + d2i_ij*we1) @ W2 + b2),
  optionally gated by sigmoid(m_ij . watt + batt).  [B, N, H]
- ``edge_vector_reduce``: the same chain up to m, then a scalar
  phi_ij = m_ij . wout (tanh-clamped), weighting the normalised
  difference or cross-product direction.  [B, N, 3]

They take the same arguments as the JAX package's Pallas kernels
(``diffndm_tpu/ops/pallas_egnn.py``), without the TPU tile options.  A
wrapper given CPU tensors computes its plain PyTorch version
(``*_plain``); given CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper.

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
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "egnn_edge.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SUPPORTED_HIDDEN = (128, 192, 256)

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


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"egnn_edge-{tag}.so"


def build_library() -> Path:
    """Compile csrc/egnn_edge.cu unless this source's build exists.
    The compiler's register/spill report lands beside it (``.log``)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.egnn_gcl_messages.argtypes = [p] * 11 + [i, i, i, i, f, p]
    lib.egnn_gcl_messages.restype = i
    lib.egnn_edge_vector_reduce.argtypes = (
        [p] * 12 + [i, i, i, i, i, f, f, i, f, p])
    lib.egnn_edge_vector_reduce.restype = i
    return lib


def _check_cuda(name: str, tensors: dict, shapes: dict) -> None:
    dev = tensors["a"].device
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, a on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")


def _shapes(bsz: int, n: int, h: int) -> dict:
    return {"a": (bsz, n, h), "b": (bsz, n, h), "d2c": (bsz, n, n),
            "d2i": (bsz, n, n), "adj": (bsz, n, n), "we": (2, h),
            "w2": (h, h), "b2": (h,), "watt": (h, 1), "batt": (1,),
            "wout": (h, 1), "x": (bsz, n, 3), "center": (bsz, 1, 3)}


def _hidden_ok(name: str, h: int) -> None:
    if h not in SUPPORTED_HIDDEN:
        raise ValueError(f"{name}: the CUDA kernel takes hidden width in "
                         f"{SUPPORTED_HIDDEN}, got {h}")


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
    rows = n if n_rows is None else max(0, min(n, int(n_rows)))
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
    bsz, n, h = a.shape
    _hidden_ok("gcl_messages", h)
    if batt is None:
        batt = torch.zeros((1,), dtype=torch.float32, device=a.device)
    _check_cuda("gcl_messages",
                dict(a=a, b=b, d2c=d2c, d2i=d2i, adj=adj, we=we, w2=w2,
                     b2=b2, watt=watt, batt=batt), _shapes(bsz, n, h))
    out = torch.empty((bsz, n, h), dtype=torch.float32, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.egnn_gcl_messages(
            *(t.data_ptr() for t in (a, b, d2c, d2i, adj, we, w2, b2, watt,
                                     batt, out)),
            bsz, n, h, int(bool(attention)), float(norm_factor), stream)
    if err != 0:
        raise RuntimeError(f"gcl_messages: CUDA launch failed (error {err})")
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
    bsz, n, h = a.shape
    _hidden_ok("edge_vector_reduce", h)
    _check_cuda("edge_vector_reduce",
                dict(a=a, b=b, d2c=d2c, d2i=d2i, adj=adj, x=x, center=center,
                     we=we, w2=w2, b2=b2, wout=wout), _shapes(bsz, n, h))
    rows = n if n_rows is None else max(0, min(n, int(n_rows)))
    out = torch.empty((bsz, n, 3), dtype=torch.float32, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.egnn_edge_vector_reduce(
            *(t.data_ptr() for t in (a, b, d2c, d2i, adj, x, center, we, w2,
                                     b2, wout, out)),
            bsz, n, h, rows, int(bool(tanh)),
            float(coords_range), float(norm_constant), int(bool(cross)),
            float(norm_factor), stream)
    if err != 0:
        raise RuntimeError(
            f"edge_vector_reduce: CUDA launch failed (error {err})")
    LAUNCHES["edge_vector_reduce"] += 1
    return out
