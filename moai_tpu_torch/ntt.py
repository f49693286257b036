"""Negacyclic NTT/INTT over RNS limbs.

Port of ``moai_tpu/ntt.py``.  Same contract: data ``[..., L, N]`` of
Montgomery residues, output index k holds the evaluation at root exponent
2k+1 (natural order), the Montgomery factor is preserved, and
``limb_slice=(lo, hi)`` selects the tables' absolute limbs.

``ntt``/``intt`` dispatch on the tensor's device: a CUDA tensor launches
the hand-written kernels of ``ntt_cuda`` (csrc/ntt.cu), a CPU tensor takes
the plain PyTorch transforms ``ntt_plain``/``intt_plain``.  The plain
transforms are the 4-step formulation of the JAX package, op for op; they
are the CPU path and the version the kernels are held against on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mod_arith as ma
from .primes import primitive_root_2n, inv_mod


def _bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _split(n: int) -> tuple[int, int]:
    logn = n.bit_length() - 1
    l1 = logn // 2
    return 1 << l1, 1 << (logn - l1)


def _pow_mod_vec(base: int, exps: np.ndarray, q: int) -> np.ndarray:
    """Vectorized base**exps mod q (q < 2**30, exact in uint64)."""
    result = np.ones(exps.shape, dtype=np.uint64)
    b = np.uint64(base % q)
    e = exps.astype(np.uint64)
    qq = np.uint64(q)
    nbits = int(exps.max()).bit_length() if exps.size else 0
    for _ in range(nbits):
        odd = (e & np.uint64(1)).astype(bool)
        result[odd] = result[odd] * b % qq
        b = b * b % qq
        e = e >> np.uint64(1)
    return result


def _shoup_vec(w: np.ndarray, q: int) -> np.ndarray:
    """Shoup companions floor(w*2^32/q) of true residues w < q < 2^30."""
    return ((w.astype(np.uint64) << 32) // np.uint64(q)).astype(np.uint32)


class NttTables:
    """Per-context twiddle tables for a list of primes.

    The host arrays (numpy uint32) have the JAX package's names and values;
    ``to(device)`` gives the int64 tensors the plain transforms read.
    """

    def __init__(self, logN: int, qs: list[int]):
        self.logN = logN
        self.N = N = 1 << logN
        self.qs = list(qs)
        n1, n2 = _split(N)
        self.n1, self.n2 = n1, n2
        L = len(qs)

        consts = [ma.mont_constants(q) for q in qs]
        self.q = np.array(qs, dtype=np.uint32)
        self.qneg_inv = np.array([c["qneg_inv"] for c in consts], np.uint32)
        self.r2 = np.array([c["r2"] for c in consts], dtype=np.uint32)
        self.r1 = np.array([c["r1"] for c in consts], dtype=np.uint32)
        self.rinv = np.array([c["rinv"] for c in consts], dtype=np.uint32)
        self.psi = [primitive_root_2n(q, 2 * N) for q in qs]

        jj = np.arange(N, dtype=np.int64)
        # plain-residue twiddles + Shoup companions (mod_arith.shoup_mul);
        # a plain multiplier preserves the Montgomery form of the data
        self.psi_pl = np.zeros((L, N), dtype=np.uint32)
        self.psi_sh = np.zeros((L, N), dtype=np.uint32)
        self.psiinv_n_pl = np.zeros((L, N), dtype=np.uint32)
        self.psiinv_n_sh = np.zeros((L, N), dtype=np.uint32)
        self.w_mid_pl = np.zeros((L, n1, n2), dtype=np.uint32)
        self.w_mid_sh = np.zeros((L, n1, n2), dtype=np.uint32)
        self.w_mid_inv_pl = np.zeros((L, n1, n2), dtype=np.uint32)
        self.w_mid_inv_sh = np.zeros((L, n1, n2), dtype=np.uint32)
        mid_exp = (np.arange(n1, dtype=np.int64)[:, None]
                   * np.arange(n2, dtype=np.int64)[None, :]) % N
        for i, q in enumerate(qs):
            psi = self.psi[i]
            psii = inv_mod(psi, q)
            ninv = inv_mod(N, q)
            psi_t = _pow_mod_vec(psi, jj, q)
            self.psi_pl[i] = psi_t.astype(np.uint32)
            self.psi_sh[i] = _shoup_vec(psi_t, q)
            pij = _pow_mod_vec(psii, jj, q) * np.uint64(ninv) % np.uint64(q)
            self.psiinv_n_pl[i] = pij.astype(np.uint32)
            self.psiinv_n_sh[i] = _shoup_vec(pij, q)
            omega = psi * psi % q
            mid_t = _pow_mod_vec(omega, mid_exp, q)
            midi_t = _pow_mod_vec(inv_mod(omega, q), mid_exp, q)
            self.w_mid_pl[i] = mid_t.astype(np.uint32)
            self.w_mid_sh[i] = _shoup_vec(mid_t, q)
            self.w_mid_inv_pl[i] = midi_t.astype(np.uint32)
            self.w_mid_inv_sh[i] = _shoup_vec(midi_t, q)

        # stage twiddles for the axis NTT sizes (DIF order): an n-point
        # cyclic NTT with root w_n = omega^(N/n); the DIF stage of block
        # size t uses w_n^((n/t) j), j < t/2.  Each entry: [L, 2, t/2] of
        # (plain, shoup).
        self.stage_tw = {}
        self.stage_tw_inv = {}
        for n in sorted({n1, n2}):
            fwd_stages, inv_stages = [], []
            t = n
            while t > 1:
                half = t // 2
                fw = np.zeros((L, 2, half), dtype=np.uint32)
                iw = np.zeros((L, 2, half), dtype=np.uint32)
                ex = np.arange(half, dtype=np.int64) * (n // t)
                for i, q in enumerate(qs):
                    omega = self.psi[i] * self.psi[i] % q
                    wn = pow(omega, N // n, q)
                    f_t = _pow_mod_vec(wn, ex, q)
                    i_t = _pow_mod_vec(inv_mod(wn, q), ex, q)
                    fw[i, 0] = f_t.astype(np.uint32)
                    fw[i, 1] = _shoup_vec(f_t, q)
                    iw[i, 0] = i_t.astype(np.uint32)
                    iw[i, 1] = _shoup_vec(i_t, q)
                fwd_stages.append(fw)
                inv_stages.append(iw)
                t = half
            self.stage_tw[n] = fwd_stages
            self.stage_tw_inv[n] = list(reversed(inv_stages))
        self.bitrev = {n: _bitrev_perm(n) for n in {n1, n2}}

    def to(self, device) -> dict:
        """Tables of the plain transforms as int64 tensors on ``device``
        (their lanes: a Shoup companion needs 32 unsigned bits)."""
        def t(a):
            return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)
        return {
            "q": t(self.q),
            "psi_pl": t(self.psi_pl), "psi_sh": t(self.psi_sh),
            "psiinv_n_pl": t(self.psiinv_n_pl),
            "psiinv_n_sh": t(self.psiinv_n_sh),
            "w_mid_pl": t(self.w_mid_pl), "w_mid_sh": t(self.w_mid_sh),
            "w_mid_inv_pl": t(self.w_mid_inv_pl),
            "w_mid_inv_sh": t(self.w_mid_inv_sh),
            "stage_tw": {n: [t(a) for a in v]
                         for n, v in self.stage_tw.items()},
            "stage_tw_inv": {n: [t(a) for a in v]
                             for n, v in self.stage_tw_inv.items()},
            "bitrev": {n: t(v) for n, v in self.bitrev.items()},
        }


# ---------------------------------------------------------------------------
# plain transforms.  Data shape: [..., L, N]; limb axis is -2.
# ---------------------------------------------------------------------------

def _axis_ntt_dif(x, stages, bitrev, q):
    """n-point cyclic NTT along axis -2 of [..., L, n, m]; natural->natural.
    q: per-limb moduli [L, 1]."""
    n, m = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    q4 = q.reshape(-1, 1, 1, 1)
    t = n
    for tw in stages:                      # tw: [L, 2, t/2] (plain, shoup)
        half = t // 2
        blocks = n // t
        xv = x.reshape(lead + (blocks, 2, half, m))
        u = xv[..., 0, :, :]               # [..., L, blocks, half, m]
        v = xv[..., 1, :, :]
        twp = tw[:, 0].reshape(-1, 1, half, 1)   # [L, 1, half, 1]
        tws = tw[:, 1].reshape(-1, 1, half, 1)
        s = (u + v).remainder_(q4)
        d = ma.shoup_mul((u - v).remainder_(q4), twp, tws, q4)
        x = torch.stack([s, d], dim=-3).reshape(lead + (n, m))
        t = half
    return torch.index_select(x, -2, bitrev)


def _axis_intt_dit(x, stages_inv, bitrev, q):
    """Inverse of _axis_ntt_dif (without the 1/n factor)."""
    n, m = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    q4 = q.reshape(-1, 1, 1, 1)
    x = torch.index_select(x, -2, bitrev)  # to DIF output order
    t = 1
    for tw in stages_inv:                  # reversed stage order, w^{-1}
        half = t
        t *= 2
        blocks = n // t
        xv = x.reshape(lead + (blocks, 2, half, m))
        a = xv[..., 0, :, :]
        b = xv[..., 1, :, :]
        twp = tw[:, 0].reshape(-1, 1, half, 1)
        tws = tw[:, 1].reshape(-1, 1, half, 1)
        bw = ma.shoup_mul(b, twp, tws, q4)
        u = (a + bw).remainder_(q4)
        v = (a - bw).remainder_(q4)
        x = torch.stack([u, v], dim=-3).reshape(lead + (n, m))
    return x


def _sl(a, limb_slice):
    return a if limb_slice is None else a[limb_slice[0]:limb_slice[1]]


def ntt_plain(x, tb: dict, limb_slice=None):
    """Forward negacyclic NTT in plain PyTorch ops (any device).
    x: [..., L, N] canonical Montgomery residues (int32, or int64);
    tb: ``NttTables.to(device)``.  Computes on int64 lanes, returns int32."""
    N = x.shape[-1]
    n1, n2 = tb["w_mid_pl"].shape[-2], tb["w_mid_pl"].shape[-1]
    q = _sl(tb["q"], limb_slice).reshape(-1, 1)
    if q.shape[0] != x.shape[-2]:
        raise ValueError(f"{q.shape[0]} table limbs for data {tuple(x.shape)}")
    x = ma.shoup_mul(x.to(torch.int64), _sl(tb["psi_pl"], limb_slice),
                     _sl(tb["psi_sh"], limb_slice), q)
    x = x.reshape(x.shape[:-1] + (n1, n2))
    x = _axis_ntt_dif(x, [_sl(a, limb_slice) for a in tb["stage_tw"][n1]],
                      tb["bitrev"][n1], q)
    x = ma.shoup_mul(x, _sl(tb["w_mid_pl"], limb_slice),
                     _sl(tb["w_mid_sh"], limb_slice), q.reshape(-1, 1, 1))
    x = x.transpose(-1, -2)
    x = _axis_ntt_dif(x, [_sl(a, limb_slice) for a in tb["stage_tw"][n2]],
                      tb["bitrev"][n2], q)
    return x.reshape(x.shape[:-2] + (N,)).to(torch.int32)


def intt_plain(x, tb: dict, limb_slice=None):
    """Inverse negacyclic NTT in plain PyTorch ops (exact inverse of
    ``ntt_plain``, 1/N included)."""
    N = x.shape[-1]
    n1, n2 = tb["w_mid_pl"].shape[-2], tb["w_mid_pl"].shape[-1]
    q = _sl(tb["q"], limb_slice).reshape(-1, 1)
    if q.shape[0] != x.shape[-2]:
        raise ValueError(f"{q.shape[0]} table limbs for data {tuple(x.shape)}")
    x = x.to(torch.int64).reshape(x.shape[:-1] + (n2, n1))
    x = _axis_intt_dit(x, [_sl(a, limb_slice)
                           for a in tb["stage_tw_inv"][n2]],
                       tb["bitrev"][n2], q)
    x = x.transpose(-1, -2)
    x = ma.shoup_mul(x, _sl(tb["w_mid_inv_pl"], limb_slice),
                     _sl(tb["w_mid_inv_sh"], limb_slice), q.reshape(-1, 1, 1))
    x = _axis_intt_dit(x, [_sl(a, limb_slice)
                           for a in tb["stage_tw_inv"][n1]],
                       tb["bitrev"][n1], q)
    x = x.reshape(x.shape[:-2] + (N,))
    return ma.shoup_mul(x, _sl(tb["psiinv_n_pl"], limb_slice),
                        _sl(tb["psiinv_n_sh"], limb_slice), q).to(torch.int32)


def ntt(x, tb: dict, limb_slice=None):
    """Forward negacyclic NTT.  A CUDA tensor launches the kernel
    (tables ``tb["cuda"]``), a CPU tensor takes ``ntt_plain``."""
    if x.is_cuda:
        from .ntt_cuda import ntt_cuda
        return ntt_cuda(x.contiguous(), tb["cuda"], limb_slice)
    return ntt_plain(x, tb, limb_slice)


def intt(x, tb: dict, limb_slice=None):
    """Inverse negacyclic NTT; dispatches as ``ntt`` does."""
    if x.is_cuda:
        from .ntt_cuda import intt_cuda
        return intt_cuda(x.contiguous(), tb["cuda"], limb_slice)
    return intt_plain(x, tb, limb_slice)
