"""Encryptor / Decryptor: client-side RLWE encryption around device NTTs.

Port of ``moai_tpu/encrypt.py``.  The randomness is drawn on the host in
the JAX package's order (all of u, then all of e0, then all of e1), so a
ciphertext is bit-identical to the JAX package's for one seed.  The
residues, NTTs and products run on the context's device in chunks of the
flattened leading batch, so a wide batch (the 768 input columns of a BERT
layer) never holds more than one chunk's residues at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mod_arith as ma
from .params import Context, check_device
from .ciphertext import Ciphertext, Plaintext
from .encoder import Encoder
from .keys import KeyGenerator, PublicKey, SecretKey, coeffs_to_ntt, \
    residues_to_ntt
from .ntt import intt

CHUNK = 32      # leading-batch rows per device step of encode / encrypt


def encode_ntt(ctx: Context, encoder: Encoder, vals, scale: float, n_q: int
               ) -> torch.Tensor:
    """Host-encode slot values [..., slots] -> NTT Montgomery residues
    [..., n_q, N] on the context's device."""
    return rounded_to_ntt(ctx, encoder, encoder.encode_coeffs(vals, scale),
                          n_q)


def rounded_to_ntt(ctx: Context, encoder: Encoder, rounded: np.ndarray,
                   n_q: int) -> torch.Tensor:
    """Rounded integer coefficients [..., N] (float64, from
    ``Encoder.encode_coeffs``) -> NTT Montgomery residues [..., n_q, N] on
    the context's device."""
    lead = rounded.shape[:-1]
    flat = rounded.reshape(-1, ctx.cfg.N)
    out = torch.empty((flat.shape[0], n_q, ctx.cfg.N), dtype=torch.int64,
                      device=ctx.device)
    for lo in range(0, flat.shape[0], CHUNK):
        part = flat[lo:lo + CHUNK]
        if np.abs(part).max() < 2 ** 62:
            out[lo:lo + CHUNK] = coeffs_to_ntt(ctx, part, 0, n_q)
        else:                           # exact big-int residues (host)
            res = torch.from_numpy(encoder.residues(part, n_q).astype(
                np.int64)).to(ctx.device)
            out[lo:lo + CHUNK] = residues_to_ntt(ctx, res, 0, n_q)
    return out.reshape(lead + (n_q, ctx.cfg.N))


class Encryptor:
    def __init__(self, ctx: Context, encoder: Encoder, pk: PublicKey,
                 keygen: KeyGenerator, device="cuda"):
        self.ctx = ctx
        self.device = check_device(ctx, device)
        self.encoder = encoder
        self.pk = pk
        from .csprng import ShakeRng
        self.rng = ShakeRng(int(keygen.rng.integers(1 << 62)))

    def encode(self, vals, scale: float | None = None,
               n_q: int | None = None) -> Plaintext:
        """Host-encode to a device Plaintext (NTT Montgomery)."""
        n_q = n_q if n_q is not None else self.ctx.L
        scale = float(scale if scale is not None else self.ctx.scale)
        return Plaintext(encode_ntt(self.ctx, self.encoder, vals, scale, n_q),
                         scale)

    def encrypt(self, pt: Plaintext) -> Ciphertext:
        """Public-key encrypt: (u*pk0 + e0 + m, u*pk1 + e1), fresh
        randomness per leading batch element."""
        ctx = self.ctx
        n_q = pt.n_q
        N = ctx.cfg.N
        bshape = tuple(pt.data.shape[:-2])
        u = self.rng.choice(np.array([-1, 0, 1]), size=bshape + (N,))
        e0 = np.round(self.rng.normal(0, ctx.cfg.noise_std, bshape + (N,))
                      ).astype(np.int64)
        e1 = np.round(self.rng.normal(0, ctx.cfg.noise_std, bshape + (N,))
                      ).astype(np.int64)
        u, e0, e1 = (a.reshape(-1, N) for a in (u, e0, e1))
        m = pt.data.reshape(-1, n_q, N)
        q = ctx.dev["q"][:n_q].reshape(-1, 1)
        rinv = ctx.dev["rinv"][:n_q].reshape(-1, 1)
        pk0, pk1 = self.pk.data[0, :n_q], self.pk.data[1, :n_q]
        out = torch.empty((m.shape[0], 2, n_q, N), dtype=torch.int64,
                          device=ctx.device)
        for lo in range(0, m.shape[0], CHUNK):
            hi = lo + CHUNK
            u_ntt = coeffs_to_ntt(ctx, u[lo:hi], 0, n_q)
            c0 = ma.mont_mul(u_ntt, pk0, q, rinv)
            c0 += coeffs_to_ntt(ctx, e0[lo:hi], 0, n_q)
            c0 += m[lo:hi]
            out[lo:hi, 0] = c0.remainder_(q)
            c1 = ma.mont_mul(u_ntt, pk1, q, rinv)
            c1 += coeffs_to_ntt(ctx, e1[lo:hi], 0, n_q)
            out[lo:hi, 1] = c1.remainder_(q)
        return Ciphertext(out.reshape(bshape + (2, n_q, N)), pt.scale)

    def encrypt_values(self, vals, scale: float | None = None,
                       n_q: int | None = None) -> Ciphertext:
        return self.encrypt(self.encode(vals, scale=scale, n_q=n_q))


class Decryptor:
    """Test-harness decryption (no evaluator op ever sees the secret)."""

    def __init__(self, ctx: Context, encoder: Encoder, sk: SecretKey,
                 device="cuda"):
        self.ctx = ctx
        self.device = check_device(ctx, device)
        self.encoder = encoder
        self.sk = sk

    def decrypt_to_residues(self, ct: Ciphertext) -> np.ndarray:
        """-> standard residues [..., n_q, N] (int64 numpy)."""
        n_q = ct.n_q
        dv = self.ctx.dev
        q = dv["q"][:n_q].reshape(-1, 1)
        rinv = dv["rinv"][:n_q].reshape(-1, 1)
        s = self.sk.s_ntt[:n_q]
        acc = ct.data[..., 0, :, :]
        spow = s
        for j in range(1, ct.n_polys):
            acc = ma.add_mod(acc, ma.mont_mul(ct.data[..., j, :, :], spow,
                                              q, rinv), q)
            if j + 1 < ct.n_polys:
                spow = ma.mont_mul(spow, s, q, rinv)
        coeff = intt(acc, dv["ntt"], limb_slice=(0, n_q))
        return ma.from_mont(coeff, q, rinv).cpu().numpy()

    def decrypt(self, ct: Ciphertext) -> np.ndarray:
        """-> complex slot values [..., N/2]."""
        res = self.decrypt_to_residues(ct)
        return self.encoder.decode(res, ct.scale, n_q=ct.n_q)
