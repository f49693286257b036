"""Bindings of the hand-written Hopper NTT kernels (csrc/ntt.cu).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``_build/`` beside this file
(named by the source's hash, so an edited source rebuilds), and loaded with
ctypes.  Nothing is compiled or loaded at import: a machine without the
CUDA toolkit imports this module and only fails when a kernel is asked for.

``ntt_cuda``/``intt_cuda`` take a CUDA int64 tensor ``[..., L_act, N]`` and
launch the kernel, or raise; they never fall back to the plain transforms
of ``ntt.py``.  Each launch adds one to ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .ntt import NttTables, _bitrev_perm, _pow_mod_vec, _shoup_vec
from .primes import inv_mod

SRC = Path(__file__).resolve().parent / "csrc" / "ntt.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# one block holds a row of N uint32 words in shared memory: 2^15 words are
# 128 KB; 2^16 would need 256 KB, above the 227 KB a Hopper block may have
MAX_LOG_N = 15

launches = {"ntt_fwd": 0, "ntt_inv": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the NTT kernels are compiled on "
                           "a machine with the CUDA toolkit")
    return path


def build() -> tuple[Path, str]:
    """Compile csrc/ntt.cu unless this source's library exists; returns its
    path and nvcc's messages (register and shared-memory use), which are
    empty when nothing was compiled."""
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libmoai_ntt_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moai_ntt_fwd.argtypes = [p, p, ll, i, i, p, p, p, p]
    lib.moai_ntt_inv.argtypes = [p, p, ll, i, i, p, p, p, p, p, p]
    lib.moai_ntt_fwd.restype = i
    lib.moai_ntt_inv.restype = i
    return lib


class CudaNttTables:
    """The kernels' radix-2 tables over all of a context's primes, on the
    card: ``w[l, k] = psi_l^bitrev(k)`` (forward), ``winv[l, k] =
    psi_l^-bitrev(k)`` (inverse), each with Shoup companions, and 1/N per
    limb.  Stored as int32 tensors holding the uint32 bit patterns."""

    def __init__(self, nt: NttTables, device):
        self.device = torch.device(device)
        self.N, self.log_n, self.L = nt.N, nt.logN, len(nt.qs)
        brv = _bitrev_perm(nt.N)
        shape = (self.L, nt.N)
        w, ws, wi, wis = (np.empty(shape, np.uint32) for _ in range(4))
        ninv = np.empty(self.L, np.uint32)
        ninv_sh = np.empty(self.L, np.uint32)
        for i, q in enumerate(nt.qs):
            psi = nt.psi[i]
            fw = _pow_mod_vec(psi, brv, q)
            iw = _pow_mod_vec(inv_mod(psi, q), brv, q)
            w[i], ws[i] = fw.astype(np.uint32), _shoup_vec(fw, q)
            wi[i], wis[i] = iw.astype(np.uint32), _shoup_vec(iw, q)
            n_inv = np.array([inv_mod(nt.N, q)], np.uint64)
            ninv[i], ninv_sh[i] = n_inv[0], _shoup_vec(n_inv, q)[0]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                    ).to(self.device)
        self.q = dev(nt.q)
        self.w, self.ws, self.wi, self.wis = dev(w), dev(ws), dev(wi), dev(wis)
        self.ninv, self.ninv_sh = dev(ninv), dev(ninv_sh)

    def row_ptr(self, t: torch.Tensor, lo: int) -> int:
        """Address of limb ``lo`` in a per-limb table (4-byte words)."""
        return t.data_ptr() + lo * t.stride(0) * 4


def _check(x: torch.Tensor, tables: CudaNttTables, limb_slice):
    """Validate a launch; returns (first limb, active limbs, rows)."""
    n = x.shape[-1] if x.dim() else 0
    if n > (1 << MAX_LOG_N):
        raise ValueError(
            f"N={n}: the NTT kernels hold one row in shared memory and "
            f"take N <= {1 << MAX_LOG_N} (N=2^16 needs a two-pass design)")
    if not x.is_cuda:
        raise ValueError("the NTT kernels take a CUDA tensor; the plain "
                         "transforms are ntt.ntt_plain/intt_plain")
    if x.dtype != torch.int64:
        raise TypeError(f"residues must be int64, got {x.dtype}")
    if x.dim() < 2 or n != tables.N:
        raise ValueError(f"shape {tuple(x.shape)} is not [..., L, {tables.N}]")
    if not x.is_contiguous():
        raise ValueError("the NTT kernels take a contiguous tensor")
    if x.device != tables.device:
        raise ValueError(f"data on {x.device}, tables on {tables.device}")
    lo, hi = limb_slice if limb_slice is not None else (0, tables.L)
    if not (0 <= lo < hi <= tables.L) or x.shape[-2] != hi - lo:
        raise ValueError(f"limb slice {(lo, hi)} does not fit data "
                         f"{tuple(x.shape)} and {tables.L} table limbs")
    return lo, hi - lo, x.numel() // n


def ntt_cuda(x: torch.Tensor, tables: CudaNttTables, limb_slice=None):
    """Forward negacyclic NTT of every row of ``x`` on the card."""
    lo, limbs, rows = _check(x, tables, limb_slice)
    y = torch.empty_like(x)
    if rows:
        with torch.cuda.device(x.device):
            err = _lib().moai_ntt_fwd(
                x.data_ptr(), y.data_ptr(), rows, limbs, tables.log_n,
                tables.row_ptr(tables.q, lo), tables.row_ptr(tables.w, lo),
                tables.row_ptr(tables.ws, lo),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"moai_ntt_fwd launch failed: CUDA error {err}")
        launches["ntt_fwd"] += 1
    return y


def intt_cuda(x: torch.Tensor, tables: CudaNttTables, limb_slice=None):
    """Inverse negacyclic NTT (1/N included) of every row on the card."""
    lo, limbs, rows = _check(x, tables, limb_slice)
    y = torch.empty_like(x)
    if rows:
        with torch.cuda.device(x.device):
            err = _lib().moai_ntt_inv(
                x.data_ptr(), y.data_ptr(), rows, limbs, tables.log_n,
                tables.row_ptr(tables.q, lo), tables.row_ptr(tables.wi, lo),
                tables.row_ptr(tables.wis, lo),
                tables.row_ptr(tables.ninv, lo),
                tables.row_ptr(tables.ninv_sh, lo),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"moai_ntt_inv launch failed: CUDA error {err}")
        launches["ntt_inv"] += 1
    return y
