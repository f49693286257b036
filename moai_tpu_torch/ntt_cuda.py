"""Bindings of the hand-written Hopper NTT kernels (csrc/ntt.cu).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use and loaded with ctypes
(``cuda_build``).  Nothing is compiled or loaded at import: a machine
without the CUDA toolkit imports this module and only fails when a kernel
is asked for.

``ntt_cuda``/``intt_cuda`` take a CUDA int32 tensor ``[..., L_act, N]``,
2^9 <= N <= 2^16, and launch the kernels, or raise; they never fall back to
the plain transforms of ``ntt.py``.  A call is two device kernels, the two
passes of the 4-step split N = n1 * n2 (``ntt._split``), which hand each
other a uint32 scratch the wrapper allocates; each call adds one to
``launches``.
"""

from __future__ import annotations

import copy
import ctypes
import functools

import numpy as np
import torch

from . import cuda_build
from .ntt import NttTables, _bitrev_perm, _pow_mod_vec, _shoup_vec
from .primes import inv_mod

# the kernels tile N = n1 * n2 with n1, n2 = _split(N) and at most 256 x
# 256 points (a 256-point tile of 32 transforms is 35 KB of shared memory)
MIN_LOG_N, MAX_LOG_N = 9, 16

launches = {"ntt_fwd": 0, "ntt_inv": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("ntt")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moai_ntt_fwd.argtypes = [p, p, p, ll, i, i, p, p, p, p, p]
    lib.moai_ntt_inv.argtypes = [p, p, p, ll, i, i, p, p, p, p, p]
    lib.moai_ntt_fwd.restype = i
    lib.moai_ntt_inv.restype = i
    return lib


class CudaNttTables:
    """The kernels' tables over all of a context's primes, on ``device``.

    Per limb, each entry a (twiddle, Shoup companion) pair of uint32, held
    as int32 tensors [..., 2] with the uint32 bit patterns (psi: the limb's
    primitive 2N-th root; n1, n2 = ``_split(N)``; brv: bit reversal):

    - ``fwd_cols`` [L, n1]: ``psi^(n2 brv(k))``, the n1-point negacyclic
      Cooley-Tukey table of root psi1 = psi^n2 (the twist psi^(j1 n2));
    - ``fwd_mid`` [L, n1, n2]: ``psi^((2 k1 + 1) j2)``;
    - ``fwd_rows`` [L, n2]: entry m + i (stage m, block i) is
      ``w^((n2 / 2m) brv_m(i))``, the n2-point cyclic table of w = psi^(2 n1);
    - ``inv_rows``, ``inv_cols``: the inverses of ``fwd_rows``, ``fwd_cols``;
    - ``inv_mid`` [L, n1, n2]: ``psi^-((2 k1 + 1) j2) / N``.

    Entry 0 of the small tables is unused (1).  ``q`` [L] holds the primes.
    """

    def __init__(self, nt: NttTables, device):
        self.device = torch.device(device)
        self.N, self.log_n, self.L = nt.N, nt.logN, len(nt.qs)
        N, n1, n2 = nt.N, nt.n1, nt.n2
        e_cols = n2 * _bitrev_perm(n1)
        e_rows = np.zeros(n2, np.int64)
        m = 1
        while m < n2:
            e_rows[m:2 * m] = (N // m) * _bitrev_perm(m)
            m *= 2
        k1 = np.arange(n1, dtype=np.int64)[:, None]
        j2 = np.arange(n2, dtype=np.int64)[None, :]
        e_mid = (2 * k1 + 1) * j2 % (2 * N)
        tabs = {k: [] for k in ("fwd_cols", "fwd_mid", "fwd_rows",
                                "inv_rows", "inv_mid", "inv_cols")}
        for q, psi in zip(nt.qs, nt.psi):
            pw = _pow_mod_vec(psi, np.arange(2 * N, dtype=np.int64), q)
            ninv = np.uint64(inv_mod(N, q))
            for name, w in (
                    ("fwd_cols", pw[e_cols]),
                    ("fwd_mid", pw[e_mid]),
                    ("fwd_rows", pw[e_rows]),
                    ("inv_rows", pw[-e_rows % (2 * N)]),
                    ("inv_mid", pw[-e_mid % (2 * N)] * ninv % np.uint64(q)),
                    ("inv_cols", pw[-e_cols % (2 * N)])):
                tabs[name].append(np.stack(
                    [w.astype(np.uint32), _shoup_vec(w, q)], axis=-1))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                    ).to(self.device)
        self.q = dev(nt.q)
        for name, v in tabs.items():
            setattr(self, name, dev(np.stack(v)))

    def to(self, device) -> "CudaNttTables":
        """The same tables on another card (itself on this one)."""
        device = torch.device(device)
        if device == self.device:
            return self
        out = copy.copy(self)
        out.device = device
        for name in ("q", "fwd_cols", "fwd_mid", "fwd_rows", "inv_rows",
                     "inv_mid", "inv_cols"):
            setattr(out, name, getattr(self, name).to(device))
        return out

    def row_ptr(self, t: torch.Tensor, lo: int) -> int:
        """Address of limb ``lo`` in a per-limb table (4-byte words)."""
        return t.data_ptr() + lo * t.stride(0) * 4


def _check(x: torch.Tensor, tables: CudaNttTables, limb_slice):
    """Validate a launch; returns (first limb, active limbs, rows)."""
    n = x.shape[-1] if x.dim() else 0
    if not (1 << MIN_LOG_N <= n <= 1 << MAX_LOG_N) or n & (n - 1):
        raise ValueError(
            f"N={n}: the NTT kernels take N = 2^{MIN_LOG_N} .. "
            f"2^{MAX_LOG_N} (a 4-step split of at most 256 x 256)")
    if not x.is_cuda:
        raise ValueError("the NTT kernels take a CUDA tensor; the plain "
                         "transforms are ntt.ntt_plain/intt_plain")
    if x.dtype != torch.int32:
        raise TypeError(f"residues must be int32, got {x.dtype}")
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


def _launch(name: str, x, tables, limb_slice, table_names):
    lo, limbs, rows = _check(x, tables, limb_slice)
    y = torch.empty_like(x)
    if rows:
        scratch = torch.empty(x.shape, dtype=torch.int32, device=x.device)
        ptrs = [tables.row_ptr(getattr(tables, t), lo)
                for t in ("q", *table_names)]
        with torch.cuda.device(x.device):
            err = getattr(_lib(), f"moai_{name}")(
                x.data_ptr(), y.data_ptr(), scratch.data_ptr(), rows, limbs,
                tables.log_n, *ptrs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"moai_{name} launch failed: CUDA error {err}")
        launches[name] += 1
    return y


def ntt_cuda(x: torch.Tensor, tables: CudaNttTables, limb_slice=None):
    """Forward negacyclic NTT of every row of ``x`` on the card."""
    return _launch("ntt_fwd", x, tables, limb_slice,
                   ("fwd_cols", "fwd_mid", "fwd_rows"))


def intt_cuda(x: torch.Tensor, tables: CudaNttTables, limb_slice=None):
    """Inverse negacyclic NTT (1/N included) of every row on the card."""
    return _launch("ntt_inv", x, tables, limb_slice,
                   ("inv_rows", "inv_mid", "inv_cols"))
