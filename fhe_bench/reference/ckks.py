"""Plain CKKS decryption and decoding, written apart from the program.

The judge reads a ciphertext that the program produced and nothing else of
it: the residues [..., 2, n, N] (int32, the Montgomery value x * 2^32 mod q
in the evaluation domain, index t holding the evaluation at psi^(2t+1) for
psi the least primitive 2N-th root of unity mod q) and the scale the
ciphertext declares.  The primes come from the configuration file, the
secret key from the seed, through the client's sampler, worked out here
again.  Nothing here imports the program.

- ``secret_key``: the client's sparse ternary secret for a seed (the first
  block of the SHAKE-256 stream b"moai-tpu-drbg|" + seed + counter 0,
  Fisher-Yates over the N positions, then the signs).
- ``decrypt_coeffs``: c0 + c1 s in the evaluation domain, an inverse
  negacyclic transform, every limb's coefficients as int64 residues.
- ``crt_message``: the signed message from the two bottom limbs (their
  product is above 2^59), and the count of residues of the other limbs
  that disagree with it: a valid ciphertext holds one integer in all.
- ``decode``: coefficients / scale through the canonical embedding, slot j
  at the exponent 5^j.
- ``trivial_ciphertext``: the other way, for the control: slot values at a
  scale -> the residues of the ciphertext (m, 0), which decrypts to them
  under any secret, in the program's format.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

DOMAIN = b"moai-tpu-drbg|"
MONT_BITS = 32


def secret_key(seed: int, N: int, hamming_weight: int) -> np.ndarray:
    """The client's secret for ``seed``: int64 [N], ``hamming_weight``
    entries of +-1 and zeros elsewhere."""
    if seed < 0 or hamming_weight <= 0 or 16 * hamming_weight > 1 << 16:
        raise ValueError("a non-negative seed and a sparse secret that "
                         "the first block of the stream covers")
    block = hashlib.shake_256(DOMAIN + seed.to_bytes(32, "little")
                              + (0).to_bytes(8, "little")).digest(
                                  16 * hamming_weight)
    u = np.frombuffer(block, dtype=np.uint64)
    pool = np.arange(N)
    for i in range(hamming_weight):
        j = i + int(u[i] % np.uint64(N - i))
        pool[i], pool[j] = pool[j], pool[i]
    signs = np.array([-1, 1])[(u[hamming_weight:] % np.uint64(2)).astype(
        np.int64)]
    s = np.zeros(N, dtype=np.int64)
    s[pool[:hamming_weight]] = signs
    return s


def _powers(base: int, count: int, q: int, device) -> torch.Tensor:
    """base^e mod q for e in [0, count), int64 (q < 2^31)."""
    e = torch.arange(count, dtype=torch.int64, device=device)
    out = torch.ones(count, dtype=torch.int64, device=device)
    b = base % q
    while bool(e.any()):
        odd = (e & 1).bool()
        out = torch.where(odd, out * b % q, out)
        b = b * b % q
        e = e >> 1
    return out


def least_root(q: int, two_n: int, device="cpu") -> int:
    """The least primitive 2N-th root of unity mod q (q = 1 mod 2N)."""
    exp = (q - 1) // two_n
    for x in range(2, 1000):
        g = pow(x, exp, q)
        if pow(g, two_n // 2, q) != 1:
            break
    else:
        raise ValueError(f"no primitive {two_n}-th root mod {q}")
    return int(_powers(g, two_n, q, device)[1::2].min())


def _bitrev(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = torch.arange(n, device=device)
    out = torch.zeros_like(idx)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def _cyclic(a: torch.Tensor, w: torch.Tensor, q: int) -> torch.Tensor:
    """A[k] = sum_t a[t] w^(k t) mod q over the last axis (length N, w [N]
    the powers of the root), radix 2 from bit-reversed input."""
    N = a.shape[-1]
    lead = a.shape[:-1]
    a = a[..., _bitrev(N, a.device)]
    m = 1
    while m < N:
        tw = w[(N // (2 * m)) * torch.arange(m, device=a.device)]
        v = a.reshape(lead + (N // (2 * m), 2, m))
        lo, hi = v[..., 0, :], v[..., 1, :] * tw % q
        a = torch.stack([(lo + hi) % q, (lo - hi) % q], dim=-2).reshape(
            lead + (N,))
        m *= 2
    return a


def decrypt_coeffs(data: torch.Tensor, primes: list[int], s: np.ndarray
                   ) -> torch.Tensor:
    """Ciphertext residues [..., 2, n, N] (int32) -> the coefficients of
    c0 + c1 s, int64 residues [..., n, N] in [0, q)."""
    if data.dim() < 3 or data.shape[-3] != 2:
        raise ValueError(f"not a 2-poly ciphertext: {tuple(data.shape)}")
    n, N = data.shape[-2:]
    dev = data.device
    nz = torch.from_numpy(np.flatnonzero(s)).to(dev)
    sign = torch.from_numpy(s[np.flatnonzero(s)]).to(dev)
    odd = 2 * torch.arange(N, device=dev) + 1
    out = torch.empty(data.shape[:-3] + (n, N), dtype=torch.int64,
                      device=dev)
    for i in range(n):
        q = int(primes[i])
        psi = least_root(q, 2 * N, dev)
        pw = _powers(psi, 2 * N, q, dev)                 # psi^e, e < 2N
        s_eval = (sign[:, None] * pw[nz[:, None] * odd[None, :] % (2 * N)]
                  ).sum(0) % q
        rinv = pow(1 << MONT_BITS, -1, q)
        c0 = data[..., 0, i, :].long() * rinv % q
        c1 = data[..., 1, i, :].long() * rinv % q
        m_eval = (c0 + c1 * s_eval % q) % q
        inv_w = pw[(2 * N - 2 * torch.arange(N, device=dev)) % (2 * N)]
        a = _cyclic(m_eval, inv_w, q)                    # omega^-kt sums
        post = pw[(2 * N - torch.arange(N, device=dev)) % (2 * N)] \
            * pow(N, -1, q) % q                          # psi^-k / N
        out[..., i, :] = a * post % q
    return out


def crt_message(coeffs: torch.Tensor, primes: list[int]
                ) -> tuple[torch.Tensor, int]:
    """(signed message [..., N] int64 from limbs 0 and 1, the number of
    residues of limbs 2.. that differ from it)."""
    q0, q1 = int(primes[0]), int(primes[1])
    r0, r1 = coeffs[..., 0, :], coeffs[..., 1, :]
    t = (r1 - r0) % q1 * pow(q0, -1, q1) % q1
    m = r0 + q0 * t
    Q = q0 * q1
    m = torch.where(m > Q // 2, m - Q, m)
    bad = 0
    for i in range(2, coeffs.shape[-2]):
        bad += int((m % int(primes[i]) != coeffs[..., i, :]).sum())
    return m, bad


def decode(m: torch.Tensor, scale: float) -> torch.Tensor:
    """Signed coefficients [..., N] at ``scale`` -> complex slots
    [..., N/2] (complex128)."""
    N = m.shape[-1]
    dev = m.device
    k = torch.arange(N, device=dev, dtype=torch.float64)
    zeta = torch.polar(torch.ones_like(k), np.pi * k / N)
    evals = torch.fft.ifft(m.double() / scale * zeta, dim=-1) * N
    rot = _powers(5, N // 2, 2 * N, dev)
    return evals[..., (rot - 1) // 2]


def encode_coeffs(slots: torch.Tensor, scale: float) -> torch.Tensor:
    """Complex slots [..., N/2] -> the signed integer coefficients
    [..., N] (int64) that ``decode`` reads back at ``scale``."""
    half = slots.shape[-1]
    N = 2 * half
    dev = slots.device
    rot = _powers(5, half, 2 * N, dev)
    evals = torch.zeros(slots.shape[:-1] + (N,), dtype=torch.complex128,
                        device=dev)
    z = slots.to(torch.complex128)
    evals[..., (rot - 1) // 2] = z
    evals[..., (2 * N - rot - 1) // 2] = z.conj()
    k = torch.arange(N, device=dev, dtype=torch.float64)
    zeta_inv = torch.polar(torch.ones_like(k), -np.pi * k / N)
    m = torch.fft.fft(evals, dim=-1) / N * zeta_inv * scale
    return torch.round(m.real).long()


def trivial_ciphertext(slots: torch.Tensor, scale: float,
                       primes: list[int]) -> torch.Tensor:
    """The ciphertext (m, 0) of ``slots`` [..., N/2] at ``scale`` on the
    limbs ``primes``: int32 residues [..., 2, n, N] in the format the
    judge reads (Montgomery, evaluation domain)."""
    m = encode_coeffs(slots, scale)
    N = m.shape[-1]
    dev = m.device
    out = torch.zeros(m.shape[:-1] + (2, len(primes), N), dtype=torch.int32,
                      device=dev)
    k = torch.arange(N, device=dev)
    for i, q in enumerate(int(p) for p in primes):
        pw = _powers(least_root(q, 2 * N, dev), 2 * N, q, dev)
        b = m % q * pw[k] % q                            # r_k psi^k
        ev = _cyclic(b, pw[0::2], q)                     # at psi^(2t+1)
        out[..., 0, i, :] = (ev * ((1 << MONT_BITS) % q) % q).int()
    return out
