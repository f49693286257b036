"""Bindings of the hand-written Hopper limb-arithmetic kernels (csrc/limb.cu).

Four kernels, each with its plain version in ``mod_arith.py`` (the CPU
path, and what the kernels are held ``torch.equal`` to on the card):

- ``limb_ew``: the Montgomery elementwise family (``add``, ``sub``,
  ``neg``, ``mul``, ``from_mont`` and the fused ``sub_mul``) over the
  broadcast of its operands, read through their strides (stride 0 along
  broadcast axes: the per-limb ``[n, 1]`` and per-column ``[C, 1, n, 1]``
  constants are never expanded);
- ``base_conv``: fast base conversion of digits of input limbs to target
  limbs (the key-switch decomposition, the mod-down by P, ModRaise);
- ``ks_mac``: the key-switch inner product over the active digits against
  both key rows, optionally through one permutation per rotation (the
  hoisted rotations' gather); a key may be a window of the rows of a
  contiguous key (a limb shard's rows, read in place);
- ``diag_mac``: the bootstrap's sum of ciphertext-times-diagonal products
  of one giant step.

Every kernel reads and writes int32 residues (the port's at-rest format),
and its per-limb tables are int32 too; each wrapper raises ``TypeError`` on
an int64 tensor (a Galois permutation, ``perm``, is an int64 index tensor).
The source is built by ``cuda_build`` at first use.  Each wrapper checks
device, dtype, shape and contiguity and raises on what its kernel does not
take; it never falls back to the torch ops.  Each launch adds one to
``launches``; a call with nothing to compute launches nothing.  Beside it,
``shapes`` counts each kernel's launches by launch shape (``ew_shape``,
``conv_shape``, ``mac_shape``, and diag_mac's (terms, B, L, N)), so a run
can name its commonest one and bound each launch.
The kernels launch on PyTorch's current stream and do not synchronise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

launches = {"limb_ew": 0, "base_conv": 0, "ks_mac": 0, "diag_mac": 0}
shapes = {"limb_ew": {}, "base_conv": {}, "ks_mac": {}, "diag_mac": {}}

EW_OPS = {"add": 0, "sub": 1, "neg": 2, "mul": 3, "from_mont": 4,
          "sub_mul": 5}
MAX_DIMS = 6          # collapsed broadcast dimensions of limb_ew
MAX_IN = 32           # input limbs of one base_conv digit
MAX_ROT = 64          # rotations of one ks_mac launch
MAX_DIGITS = 16       # digits of one ks_mac launch
MAX_TERMS = 32        # diagonals of one diag_mac launch
SMEM_BYTES = 48 * 1024

_ll, _p, _i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int


class _Operand(ctypes.Structure):
    _fields_ = [("ptr", _p), ("value", _ll), ("stride", _ll * MAX_DIMS)]


class _EwArgs(ctypes.Structure):
    _fields_ = [("inp", _Operand * 4), ("out", _p), ("size", _ll * MAX_DIMS),
                ("rows", _ll), ("ndim", _i), ("op", _i)]


class _BaseConvArgs(ctypes.Structure):
    _fields_ = [("x", _p), ("src_q", _p), ("hatinv", _p), ("hat", _p),
                ("hs0", _ll), ("hs1", _ll), ("hs2", _ll), ("tq", _p),
                ("tqs", _ll), ("k", _p), ("kq", _p), ("kqs", _ll),
                ("out", _p), ("B", _ll), ("S", _i), ("N", _i), ("D", _i),
                ("A", _i), ("T", _i)]


class _KsMacArgs(ctypes.Structure):
    _fields_ = [("y", _p), ("perm", _p), ("key", _p * MAX_ROT), ("tq", _p),
                ("tqs", _ll), ("out", _p), ("B", _ll), ("KL", _i),
                ("split", _i), ("kgap", _i), ("R", _i), ("D", _i), ("T", _i),
                ("N", _i)]


class _DiagMacArgs(ctypes.Structure):
    _fields_ = [("ct", _p * MAX_TERMS), ("pt", _p), ("q", _p), ("qs", _ll),
                ("out", _p), ("B", _ll), ("terms", _i), ("L", _i),
                ("N", _i)]


_STRUCTS = (_EwArgs, _BaseConvArgs, _KsMacArgs, _DiagMacArgs)
_ENTRY = {"limb_ew": "moai_limb_ew", "base_conv": "moai_base_conv",
          "ks_mac": "moai_ks_mac", "diag_mac": "moai_diag_mac"}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    for v in shapes.values():
        v.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("limb")
    for (name, entry), struct in zip(_ENTRY.items(), _STRUCTS):
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(struct), _p]
        fn.restype = _i
    sizes = (ctypes.c_int * 4)()
    lib.moai_limb_sizes(sizes)
    want = [ctypes.sizeof(s) for s in _STRUCTS]
    if list(sizes) != want:
        raise RuntimeError(f"csrc/limb.cu's argument structs are {list(sizes)}"
                           f" bytes, their ctypes mirrors {want}")
    return lib


def _launch(name: str, args, device: torch.device, shape=None) -> None:
    with torch.cuda.device(device):
        err = getattr(_lib(), _ENTRY[name])(
            ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{_ENTRY[name]} launch failed: CUDA error {err}")
    launches[name] += 1
    if shape is not None:
        shapes[name][shape] = shapes[name].get(shape, 0) + 1


def _device_of(tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1 or not next(iter(devs)).type == "cuda":
        raise ValueError(f"the limb kernels take tensors on one CUDA device, "
                         f"got {sorted(str(d) for d in devs)}; the plain "
                         f"versions are mod_arith's *_plain functions")
    return next(iter(devs))


def _int_tensor(t: torch.Tensor, name: str, dtype=torch.int32):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _contiguous(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _aligned16(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the "
                         f"kernel loads coefficients in vectors)")


def _vector(t: torch.Tensor, n: int, name: str) -> tuple[int, int]:
    """Address and element stride of a table whose first n entries the
    kernel reads: a vector, or a contiguous tensor read in its order."""
    _int_tensor(t, name)
    if t.numel() < n:
        raise ValueError(f"{name} has {t.numel()} entries, {n} needed")
    if t.dim() == 1:
        return t.data_ptr(), t.stride(0)
    if not t.is_contiguous():
        raise ValueError(f"{name} {tuple(t.shape)} is neither a vector nor "
                         f"contiguous")
    return t.data_ptr(), 1


# ---------------------------------------------------------------------------
# limb_ew
# ---------------------------------------------------------------------------

def _collapse(shape, strides):
    """Drop size-1 dims and merge neighbours that every operand steps
    through as one: returns (sizes, [strides per operand]), innermost last,
    at least one dim."""
    dims = [i for i, s in enumerate(shape) if s != 1]
    sizes, st = [], [[] for _ in strides]
    for i in reversed(dims):
        if sizes and all(s[i] == o[0] * sizes[0] for s, o in zip(strides, st)):
            sizes[0] *= shape[i]
            continue
        sizes.insert(0, shape[i])
        for s, o in zip(strides, st):
            o.insert(0, s[i])
    if not sizes:
        return [1], [[0] for _ in strides]
    return sizes, st


def ew_layout(ops):
    """The broadcast shape of limb_ew's operands (tensors, ints or None)
    and the launch layout: (shape, collapsed sizes, each operand's
    collapsed strides, rows = elements / innermost size)."""
    shape = torch.broadcast_shapes(
        *[t.shape for t in ops if isinstance(t, torch.Tensor)])
    strides = [list(t.expand(shape).stride()) if isinstance(t, torch.Tensor)
               else [0] * len(shape) for t in ops]
    sizes, st = _collapse(list(shape), strides)
    if len(sizes) > MAX_DIMS:
        raise ValueError(f"limb_ew: the broadcast of {tuple(shape)} needs "
                         f"{len(sizes)} dims, the kernel takes {MAX_DIMS}")
    rows = shape.numel() // sizes[-1] if shape.numel() else 0
    if rows >= 1 << 31:
        raise ValueError(f"limb_ew: {rows} rows, the kernel takes < 2^31")
    return shape, sizes, st, rows


def ew_shape(op: str, ops, numel: int, sizes, st) -> tuple:
    """limb_ew's launch shape from its layout (``ew_layout``): (op, output
    elements, then each operand's distinct elements in a, b, c, q order: a
    broadcast (stride-0) axis counted once, an int or None none)."""
    key = [op, numel]
    for t, s in zip(ops, st):
        if not isinstance(t, torch.Tensor):
            key.append(0)
        elif 0 not in s:
            key.append(numel)
        else:
            n = 1
            for size, stride in zip(sizes, s):
                if stride:
                    n *= size
            key.append(n)
    return tuple(key)


def limb_ew(op: str, a, b, c, q) -> torch.Tensor:
    """``op`` over the broadcast of a, b, c (each a CUDA int32 tensor, a
    Python int or None) modulo q (a CUDA int32 tensor or a Python int),
    every value in [0, 2^31): a new contiguous int32 tensor of canonical
    residues, equal to the plain version on that whole domain.  q is an
    odd prime below 2^30."""
    ops = (a, b, c, q)
    tensors = [t for t in ops if isinstance(t, torch.Tensor)]
    if not tensors:
        raise ValueError("limb_ew needs a tensor operand")
    device = _device_of(tensors)
    for name, t in zip("abcq", ops):
        if isinstance(t, torch.Tensor):
            _int_tensor(t, name)
        elif isinstance(t, int):
            if not 0 <= t < 1 << 31:
                raise ValueError(f"{name} = {t} is outside [0, 2^31)")
        elif t is not None:
            raise TypeError(f"{name} must be a tensor or an int, got "
                            f"{type(t).__name__}")
    shape, sizes, st, rows = ew_layout(ops)
    out = torch.empty(shape, dtype=torch.int32, device=device)
    if not rows:
        return out
    args = _EwArgs(out=out.data_ptr(), rows=rows, ndim=len(sizes),
                   op=EW_OPS[op])
    args.size[:len(sizes)] = sizes
    for k, (t, s) in enumerate(zip(ops, st)):
        o = args.inp[k]
        if isinstance(t, torch.Tensor):
            o.ptr = t.data_ptr()
        else:
            o.value = int(t or 0)
        o.stride[:len(s)] = s
    _launch("limb_ew", args, device,
            ew_shape(op, ops, shape.numel(), sizes, st))
    return out


# ---------------------------------------------------------------------------
# base_conv
# ---------------------------------------------------------------------------

def conv_shape(x: torch.Tensor, hat: torch.Tensor, hatinv, k) -> tuple:
    """base_conv's launch shape: (B, S, D, A, T, N, with hatinv, with k)."""
    S, N = x.shape[-2:]
    D, A, T = hat.shape
    B = x.numel() // (S * N) if x.numel() else 0
    return (B, S, D, A, T, N, hatinv is not None, k is not None)


def base_conv(x, src_q, hatinv, hat, tq, k=None, kq=None) -> torch.Tensor:
    """Fast base conversion on the card: x [..., S, N] (contiguous int32,
    canonical, 16-byte aligned, N even), digits of A input limbs (hat
    [D, A, T], any strides) -> [..., D, T, N] modulo tq (T entries).  With
    hatinv ([S], Montgomery hat inverses modulo src_q) each input is first
    turned into lam = from_mont(mont_mul(x, hatinv)); without it x holds
    lam.  With k ([..., N], contiguous int32) and kq (T entries),
    mont_mul(k, kq) is subtracted from each output.  See
    mod_arith.base_conv_plain."""
    tensors = [t for t in (x, src_q, hatinv, hat, tq, k, kq) if t is not None]
    device = _device_of(tensors)
    _int_tensor(x, "x")
    _contiguous(x, "x")
    _int_tensor(hat, "hat")
    if x.dim() < 2 or hat.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)} is not [..., S, N] or hat "
                         f"{tuple(hat.shape)} not [D, A, T]")
    shape = conv_shape(x, hat, hatinv, k)
    B, S, D, A, T, N = shape[:6]
    if not (0 < A <= MAX_IN and (D - 1) * A < S <= D * A):
        raise ValueError(f"{S} input limbs do not make {D} digits of {A} "
                         f"(at most {MAX_IN}) limbs")
    if N % 2:
        raise ValueError(f"base_conv takes an even N, got {N}")
    smem = 4 * ((T + 3) // 4 * 4) * (4 + A) + 16 * A
    if smem > SMEM_BYTES:
        raise ValueError(f"{T} targets x {A} limbs need {smem} bytes of "
                         f"shared memory, over {SMEM_BYTES}")
    out = torch.empty(x.shape[:-2] + (D, T, N), dtype=torch.int32,
                      device=device)
    if B == 0:
        return out
    _aligned16(x, "x")
    args = _BaseConvArgs(x=x.data_ptr(), hs0=hat.stride(0),
                         hs1=hat.stride(1), hs2=hat.stride(2),
                         hat=hat.data_ptr(), out=out.data_ptr(), B=B, S=S,
                         N=N, D=D, A=A, T=T)
    args.tq, args.tqs = _vector(tq, T, "tq")
    if hatinv is not None:
        args.src_q, s1 = _vector(src_q, S, "src_q")
        args.hatinv, s2 = _vector(hatinv, S, "hatinv")
        if (s1, s2) != (1, 1):
            raise ValueError("src_q and hatinv must be contiguous vectors")
    if k is not None:
        _int_tensor(k, "k")
        _contiguous(k, "k")
        _aligned16(k, "k")
        if k.numel() != B * N:
            raise ValueError(f"k {tuple(k.shape)} is not one row of {N} per "
                             f"input row of x {tuple(x.shape)}")
        args.k = k.data_ptr()
        args.kq, args.kqs = _vector(kq, T, "kq")
    _launch("base_conv", args, device, shape)
    return out


# ---------------------------------------------------------------------------
# ks_mac
# ---------------------------------------------------------------------------

def mac_shape(y: torch.Tensor, keys: list, q_limbs: int, perm) -> tuple:
    """ks_mac's launch shape: (R, B, D, T, N, KL, q_limbs, with perm)."""
    D, T, N = y.shape[-3:]
    B = y.numel() // (D * T * N) if y.numel() else 0
    return (len(keys), B, D, T, N, keys[0].shape[-2], q_limbs,
            perm is not None)


def _key_row_stride(key: torch.Tensor) -> int:
    """The rows between one key plane and the next of key [dnum, 2, KL, N]:
    KL for a contiguous key, more for a window of the rows of a contiguous
    key (``key[..., s:e, :]``, as a limb shard reads its rows); raises on
    any other layout."""
    _, _, KL, N = key.shape
    s = key.stride()
    if s[3] != 1 or s[2] != N or s[1] % N or s[1] < KL * N \
            or (key.shape[0] > 1 and s[0] != 2 * s[1]):
        raise ValueError(f"key {tuple(key.shape)} with strides {s} is not "
                         f"contiguous or a window of the rows of a "
                         f"contiguous key")
    return s[1] // N


def ks_mac(y, keys, q_limbs: int, tq, perm=None):
    """The key-switch MAC on the card: y [..., D, T, N] (contiguous int32,
    canonical) against the key rows of the first D digits of each key
    [dnum, 2, q_limbs + K, N] (int32, contiguous or a window of the rows of
    a contiguous key), target t read at key limb t for t < T - K and
    q_limbs + t - (T - K) above, modulo tq.  Without perm, keys is one key
    and the result is (acc0, acc1), each [..., T, N]; with perm [R, N],
    keys holds R keys (one layout), rotation r reads y at perm[r] and each
    result is [R, ..., T, N]."""
    keys = [keys] if perm is None else list(keys)
    device = _device_of([y, tq, *keys] + ([perm] if perm is not None else []))
    _int_tensor(y, "y")
    _contiguous(y, "y")
    if y.dim() < 3:
        raise ValueError(f"y {tuple(y.shape)} is not [..., D, T, N]")
    D, T, N = y.shape[-3:]
    key_shape, key_strides = keys[0].shape, keys[0].stride()
    for key in keys:
        _int_tensor(key, "key")
        if key.shape != key_shape or key.stride() != key_strides:
            raise ValueError("the keys of one launch differ in shape or "
                             "layout")
    if len(key_shape) != 4 or key_shape[0] < D or key_shape[1] != 2 \
            or key_shape[3] != N:
        raise ValueError(f"key {tuple(key_shape)} is not [>= {D}, 2, KL, {N}]")
    KL = key_shape[2]
    stride = _key_row_stride(keys[0])
    n_q = T - (KL - q_limbs)
    if not 0 < n_q <= q_limbs:
        raise ValueError(f"{T} targets do not fit a key of {q_limbs} Q limbs "
                         f"and {KL - q_limbs} special limbs")
    R = len(keys)
    if perm is not None:
        _int_tensor(perm, "perm", torch.int64)
        _contiguous(perm, "perm")
        if tuple(perm.shape) != (R, N):
            raise ValueError(f"perm {tuple(perm.shape)} is not [{R}, {N}]")
    if R > MAX_ROT:
        raise ValueError(f"{R} rotations in one launch, at most {MAX_ROT}")
    if D > MAX_DIGITS:
        raise ValueError(f"{D} digits in one launch, at most {MAX_DIGITS}")
    shape = mac_shape(y, keys, q_limbs, perm)
    B = shape[1]
    out = torch.empty((2, R) + y.shape[:-3] + (T, N), dtype=torch.int32,
                      device=device)
    if B:
        args = _KsMacArgs(y=y.data_ptr(), out=out.data_ptr(), B=B, KL=stride,
                          split=n_q, kgap=q_limbs - n_q, R=R, D=D, T=T, N=N)
        args.perm = perm.data_ptr() if perm is not None else None
        for r, key in enumerate(keys):
            args.key[r] = key.data_ptr()
        args.tq, args.tqs = _vector(tq, T, "tq")
        _launch("ks_mac", args, device, shape)
    if perm is None:
        return out[0, 0], out[1, 0]
    return out[0], out[1]


# ---------------------------------------------------------------------------
# diag_mac
# ---------------------------------------------------------------------------

def diag_mac(cts, pts, q) -> torch.Tensor:
    """One giant step's sum_j mont_mul(cts[j], pts[j]) mod q on the card:
    cts, each [..., L, N] (one shape, contiguous int32, canonical, 16-byte
    aligned), pts [len(cts), L, N] (the same), q with L entries; N a
    multiple of 4."""
    cts = list(cts)
    device = _device_of([*cts, pts, q])
    if not cts or pts.dim() != 3 or pts.shape[0] != len(cts):
        raise ValueError(f"{len(cts)} ciphertexts for diagonals "
                         f"{tuple(pts.shape)}")
    _int_tensor(pts, "pts")
    _contiguous(pts, "pts")
    L, N = pts.shape[1:]
    for ct in cts:
        _int_tensor(ct, "ct")
        _contiguous(ct, "ct")
        if ct.shape != cts[0].shape or ct.dim() < 2 \
                or tuple(ct.shape[-2:]) != (L, N):
            raise ValueError(f"ciphertext {tuple(ct.shape)} is not "
                             f"[..., {L}, {N}] as the others")
    if len(cts) > MAX_TERMS:
        raise ValueError(f"{len(cts)} diagonals in one launch, at most "
                         f"{MAX_TERMS}")
    if N % 4:
        raise ValueError(f"diag_mac takes N a multiple of 4, got {N}")
    out = torch.empty(cts[0].shape, dtype=torch.int32, device=device)
    B = out.numel() // (L * N) if out.numel() else 0
    if B:
        for t in (pts, *cts):
            _aligned16(t, "each ciphertext and pts")
        args = _DiagMacArgs(pt=pts.data_ptr(), out=out.data_ptr(), B=B,
                            terms=len(cts), L=L, N=N)
        for j, ct in enumerate(cts):
            args.ct[j] = ct.data_ptr()
        args.q, args.qs = _vector(q, L, "q")
        _launch("diag_mac", args, device, (len(cts), B, L, N))
    return out
