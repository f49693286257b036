"""Bindings of the CPMM's hand-written Hopper kernels (csrc/modmat.cu).

Two kernels around the int8 GEMM of ``modmat.mod_matmul``, each with its
plain version in ``modmat.py`` (the CPU path, and what the kernels are held
``torch.equal`` to on the card):

- ``digit_split``: one limb of x, [J, P, N] read through its strides, to
  the row-major int8 matrix [P * N, NDIG * Jp] of its balanced digit
  planes, each Jp = ``padded_j(J)`` wide with the padding columns zero;
- ``bucket_fold``: one digit bucket's int32 product [>= I, P * N] folded
  into the canonical accumulator, ``(acc + part * 2^(8k)) mod q``, written
  to a scratch accumulator or to the output limb through its strides,
  four residues a thread (N a multiple of 4, rows on 16-byte boundaries,
  as every limb of the port is), for odd q < 2^30 (the port's primes,
  as ``mod_arith.mont_constants`` requires).

Both take int32 residues (the port's at-rest format) and raise
``TypeError`` on an int64 tensor; each wrapper checks device, dtype, shape
and layout and raises on what its kernel does not take, never falling back
to the torch ops.  The source is built by ``cuda_build`` at first use.
Each launch adds one to ``launches``, and ``shapes`` counts the launches by
launch shape: digit_split's (J, P, N), bucket_fold's (I, P, N, with an
accumulator read).  These counters are the CPMM's own, apart from
``limb_cuda``'s and ``ntt_cuda``'s.  The kernels launch on PyTorch's
current stream and do not synchronise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

NDIG = 4              # balanced int8 digits of a residue (modmat.NDIG)
JP_ALIGN = 16         # digit planes start on 16-byte boundaries
FOLD_LANES = 4        # residues a bucket_fold thread moves (16 bytes)

launches = {"digit_split": 0, "bucket_fold": 0}
shapes = {"digit_split": {}, "bucket_fold": {}}

_ll, _p, _i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int


class _SplitArgs(ctypes.Structure):
    _fields_ = [("x", _p), ("sj", _ll), ("sp", _ll), ("out", _p),
                ("J", _i), ("Jp", _i), ("P", _i), ("N", _i)]


class _FoldArgs(ctypes.Structure):
    _fields_ = [("part", _p), ("acc", _p), ("out", _p), ("oi", _ll),
                ("op", _ll), ("q", _p), ("c", _p), ("I", _i), ("P", _i),
                ("N", _i)]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    for v in shapes.values():
        v.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("modmat")
    lib.moai_digit_split.argtypes = [ctypes.POINTER(_SplitArgs), _p]
    lib.moai_bucket_fold.argtypes = [ctypes.POINTER(_FoldArgs), _p]
    lib.moai_digit_split.restype = lib.moai_bucket_fold.restype = _i
    sizes = (ctypes.c_int * 2)()
    lib.moai_modmat_sizes(sizes)
    want = [ctypes.sizeof(_SplitArgs), ctypes.sizeof(_FoldArgs)]
    if list(sizes) != want:
        raise RuntimeError(f"csrc/modmat.cu's argument structs are "
                           f"{list(sizes)} bytes, their ctypes mirrors "
                           f"{want}")
    return lib


def _launch(name: str, device: torch.device, shape: tuple, *args) -> None:
    with torch.cuda.device(device):
        err = getattr(_lib(), f"moai_{name}")(
            *args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"moai_{name} launch failed: CUDA error {err}")
    launches[name] += 1
    shapes[name][shape] = shapes[name].get(shape, 0) + 1


def _device_of(tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"the modmat kernels take tensors on one CUDA "
                         f"device, got {sorted(str(d) for d in devs)}; the "
                         f"plain versions are modmat's *_plain functions")
    return next(iter(devs))


def _int32(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32, got {t.dtype}")


def padded_j(J: int) -> int:
    """The width of a digit plane: J rounded up to JP_ALIGN."""
    return -(-J // JP_ALIGN) * JP_ALIGN


def digit_split(xl: torch.Tensor) -> torch.Tensor:
    """xl [J, P, N] (int32 on the card, each row of N contiguous) -> int8
    [P * N, NDIG * Jp]: row p * N + n holds digit planes 0..3 of
    xl[:, p, n], each Jp = padded_j(J) wide, zero past J.  See
    modmat.digit_split_plain."""
    device = _device_of([xl])
    _int32(xl, "x")
    if xl.dim() != 3:
        raise ValueError(f"x {tuple(xl.shape)} is not one limb [J, P, N]")
    J, P, N = xl.shape
    Jp = padded_j(J)
    if N > 1 and xl.stride(2) != 1:
        raise ValueError(f"x's rows of N must be contiguous, strides "
                         f"{xl.stride()}")
    out = torch.empty((P * N, NDIG * Jp), dtype=torch.int8, device=device)
    if out.numel() == 0:
        return out
    args = _SplitArgs(x=xl.data_ptr(), sj=xl.stride(0), sp=xl.stride(1),
                      out=out.data_ptr(), J=J, Jp=Jp, P=P, N=N)
    _launch("digit_split", device, (J, P, N), ctypes.byref(args))
    return out


def _scalar(t: torch.Tensor, name: str) -> int:
    _int32(t, name)
    if t.numel() != 1:
        raise ValueError(f"{name} must hold one value, got {tuple(t.shape)}")
    return t.data_ptr()


def bucket_fold(part: torch.Tensor, acc, out: torch.Tensor,
                c: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """out = (acc + part[:I] * c * R^-1) mod q on the card, canonical, for
    a bucket's product part [>= I, P * N] (contiguous int32, |part| <=
    2^29), acc [I, P, N] (contiguous int32, canonical; None: zero), out
    [I, P, N] (int32, each row of N contiguous; may be acc), c and q
    one-element int32 tensors (c = 2^(8k) R mod q, odd q < 2^30).  N is
    a multiple of 4, and every row of part, acc and out starts on a
    16-byte boundary.  Returns out.  See modmat.bucket_fold_plain."""
    tensors = [part, out, c, q] + ([acc] if acc is not None else [])
    device = _device_of(tensors)
    for t, name in ((part, "part"), (out, "out")):
        _int32(t, name)
    if out.dim() != 3:
        raise ValueError(f"out {tuple(out.shape)} is not [I, P, N]")
    I, P, N = out.shape
    if part.dim() != 2 or part.shape[0] < I or part.shape[1] != P * N \
            or not part.is_contiguous():
        raise ValueError(f"part {tuple(part.shape)} is not a contiguous "
                         f"[>= {I}, {P * N}]")
    if N % FOLD_LANES or out.stride(2) != 1 \
            or out.stride(0) % FOLD_LANES or out.stride(1) % FOLD_LANES:
        raise ValueError(f"out {tuple(out.shape)}, strides {out.stride()}: "
                         f"N must be a multiple of {FOLD_LANES} and each "
                         f"row of N contiguous, from a stride a multiple "
                         f"of {FOLD_LANES}")
    if acc is not None:
        _int32(acc, "acc")
        if acc.shape != out.shape or not acc.is_contiguous():
            raise ValueError(f"acc {tuple(acc.shape)} is not a contiguous "
                             f"{tuple(out.shape)}")
    args = _FoldArgs(part=part.data_ptr(),
                     acc=acc.data_ptr() if acc is not None else None,
                     out=out.data_ptr(), oi=out.stride(0), op=out.stride(1),
                     q=_scalar(q, "q"), c=_scalar(c, "c"), I=I, P=P, N=N)
    if out.numel() == 0:
        return out
    if any(t.data_ptr() % (4 * FOLD_LANES) for t in (part, out)
           + ((acc,) if acc is not None else ())):
        raise ValueError("part, acc and out must start on 16-byte "
                         "boundaries")
    _launch("bucket_fold", device, (I, P, N, acc is not None),
            ctypes.byref(args))
    return out
