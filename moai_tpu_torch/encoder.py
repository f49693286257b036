"""CKKS encoder: canonical embedding via host FFT + exact RNS residues.

Port of ``moai_tpu/encoder.py``; encode and decode stay on the host in
numpy float64.  The JAX package hands coefficients of 2**62 or more, and
decodes past the int64 CRT window, to its native C++ helper; the port has
no native code and takes the package's own pure-Python branches: the
big-int reduction for encode, and the wrapping-uint64 CRT for decode, which
is exact while the centered value stays inside the int64 window (always the
case for the attention head's ciphertexts).  Decode checks its result
against every residue and raises outside that window.

The canonical embedding is one length-N complex FFT plus a gather: slot j
lives at exponent 5^j, and NTT index t holds exponent 2t+1 (ntt.py), so
Galois rotations are plain gathers.
"""

from __future__ import annotations

import copy

import numpy as np

from .params import Context


class Encoder:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        N = ctx.cfg.N
        self.N = N
        self.slots = N // 2
        two_n = 2 * N
        rot = np.empty(self.slots, dtype=np.int64)
        g = 1
        for j in range(self.slots):
            rot[j] = g
            g = g * 5 % two_n
        self.rot_group = rot
        self.slot_to_t = (rot - 1) // 2                        # exponent 5^j
        self.conj_slot_to_t = (two_n - rot - 1) // 2           # exponent -5^j
        k = np.arange(N)
        self.zeta_pow = np.exp(1j * np.pi * k / N)             # zeta^k
        self.zeta_pow_inv = np.exp(-1j * np.pi * k / N)

    def to(self, device) -> "Encoder":
        """The encoder of this context's replica on ``device`` (host tables
        shared); itself when the context is there."""
        ctx = self.ctx.to(device)
        if ctx is self.ctx:
            return self
        out = copy.copy(self)
        out.ctx = ctx
        return out

    # -- embedding --------------------------------------------------------
    def embed_to_slots(self, coeffs: np.ndarray) -> np.ndarray:
        """Real coefficient vector(s) [..., N] -> slots [..., N/2]."""
        twisted = coeffs.astype(np.complex128) * self.zeta_pow
        evals = np.fft.ifft(twisted, axis=-1) * self.N         # at exp 2t+1
        return evals[..., self.slot_to_t]

    def slots_to_coeffs(self, vals: np.ndarray) -> np.ndarray:
        """Slot values [..., N/2] -> real coefficient vector [..., N]."""
        vals = np.asarray(vals, dtype=np.complex128)
        full = np.zeros(vals.shape[:-1] + (self.N,), dtype=np.complex128)
        full[..., self.slot_to_t] = vals
        full[..., self.conj_slot_to_t] = np.conj(vals)
        twisted = np.fft.fft(full, axis=-1) / self.N
        return np.real(twisted * self.zeta_pow_inv)

    # -- RNS encode/decode ------------------------------------------------
    def encode_coeffs(self, vals, scale: float | None = None) -> np.ndarray:
        """Slot values -> rounded integer coefficients [..., N], float64
        (exact integers at any magnitude).  vals: scalar, [slots] or
        [..., slots]; shorter vectors are zero-padded."""
        scale = float(scale if scale is not None else self.ctx.scale)
        vals = np.asarray(vals)
        if vals.ndim == 0:
            vals = np.full(self.slots, complex(vals))
        if vals.shape[-1] < self.slots:
            pad = np.zeros(vals.shape[:-1] + (self.slots - vals.shape[-1],),
                           dtype=np.complex128)
            vals = np.concatenate([vals.astype(np.complex128), pad], axis=-1)
        return np.round(self.slots_to_coeffs(vals) * scale)

    def residues(self, rounded: np.ndarray, n_q: int) -> np.ndarray:
        """Exact standard residues [..., n_q, N] (uint32) of the
        coefficients from ``encode_coeffs``."""
        if np.abs(rounded).max() >= 2 ** 62:
            # exact big-int path: doubles are exact integers at any size
            flat = rounded.reshape(-1)
            out = np.empty((n_q, flat.size), dtype=np.uint32)
            for i in range(n_q):
                q = self.ctx.q_primes[i]
                out[i] = [int(c) % q for c in flat]
            return np.moveaxis(out.reshape((n_q,) + rounded.shape), 0, -2)
        c_int = rounded.astype(np.int64)
        out = np.empty(rounded.shape[:-1] + (n_q, self.N), dtype=np.uint32)
        for i in range(n_q):
            out[..., i, :] = (c_int % self.ctx.q_primes[i]).astype(np.uint32)
        return out

    def encode(self, vals, scale: float | None = None, n_q: int | None = None
               ) -> np.ndarray:
        """Encode slot values -> uint32 RNS residues [..., n_q, N]
        (standard representation)."""
        n_q = n_q if n_q is not None else self.ctx.L
        return self.residues(self.encode_coeffs(vals, scale), n_q)

    def decode(self, residues: np.ndarray, scale: float, n_q: int | None = None
               ) -> np.ndarray:
        """RNS residues [..., n_q, N] (standard rep) -> complex slots.

        Wrapping-uint64 CRT: m = sum_i lam_i * Qhat_i - k*Q mod 2^64, with
        k from a float64 estimate of sum_i lam_i / q_i.  The int64 result
        is then checked against every residue, so a decode either is exact
        (the centered value lies in the int64 window) or raises."""
        ctx = self.ctx
        res = np.asarray(residues).astype(np.uint64)
        n_q = n_q if n_q is not None else res.shape[-2]
        qs = ctx.q_primes[:n_q]
        Q = 1
        for q in qs:
            Q *= q
        fsum = np.zeros(res.shape[:-2] + (self.N,), dtype=np.float64)
        acc64 = np.zeros(res.shape[:-2] + (self.N,), dtype=np.uint64)
        for i, q in enumerate(qs):
            hat = Q // q
            hat_inv = pow(hat % q, -1, q)
            lam_i = res[..., i, :] * np.uint64(hat_inv) % np.uint64(q)
            fsum += lam_i.astype(np.float64) / q
            acc64 += lam_i * np.uint64(hat % (1 << 64))        # wraps mod 2^64
        k = np.round(fsum).astype(np.uint64)
        acc64 -= k * np.uint64(Q % (1 << 64))
        m_int = acc64.astype(np.int64)
        for i, q in enumerate(qs):
            if not np.array_equal(m_int % q, res[..., i, :].astype(np.int64)):
                raise ValueError("decode: centered value outside the int64 "
                                 "CRT window; decrypt at a lower level")
        return self.embed_to_slots(m_int.astype(np.float64) / scale)
