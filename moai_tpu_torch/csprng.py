"""Cryptographic sampling: SHAKE-256 DRBG with the numpy-Generator subset
the key/encryption samplers use.

A verbatim copy of ``moai_tpu/csprng.py`` (same domain string, same
streams), so that keys and ciphertexts of the two packages agree bit for
bit from one seed; tests/test_torch_mod_arith.py holds the streams equal.

The reference's randomness stack is Blake2/SHAKE-based (reference:
thirdparty/SEAL-4.1-bs/native/src/seal/util/blake2*.c, fips202.c,
randomgen.cpp; sparse-ternary sampling rlwe.cpp:46-58).  Round-2 used
numpy PCG64 — statistically fine, cryptographically not.  This DRBG
squeezes an extendable SHAKE-256 stream (hashlib, stdlib) and implements
exactly the sampler subset KeyGenerator/Encryptor consume:

- ``integers``  — uniform 64-bit draws (modulo reduction downstream has
  bias < 2^-34 for q < 2^30, far below the decryption noise floor; SEAL
  does rejection sampling, same end effect at these sizes).
- ``normal``    — Box-Muller from 53-bit uniforms (encryption/key noise;
  the reference uses a clipped CBD of the same sigma).
- ``choice``    — with ``replace=False`` a Fisher-Yates prefix shuffle
  (sparse-secret support selection), otherwise index draws.

Deterministic: a given integer seed always yields the same stream (tests
rely on seeded keygen); ``seed=None`` pulls 32 bytes from os.urandom.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

_CHUNK = 1 << 16


class ShakeRng:
    """SHAKE-256 extendable-output stream with numpy-style samplers."""

    def __init__(self, seed: int | bytes | None = None):
        if seed is None:
            seed = os.urandom(32)
        elif isinstance(seed, int):
            seed = seed.to_bytes(32, "little", signed=False) if seed >= 0 \
                else (-seed).to_bytes(32, "little") + b"-"
        self._shake = hashlib.shake_256(b"moai-tpu-drbg|" + seed)
        self._counter = 0
        self._buf = b""
        self._pos = 0

    def _refill(self, n: int) -> None:
        h = self._shake.copy()
        h.update(self._counter.to_bytes(8, "little"))
        self._counter += 1
        self._buf = h.digest(max(n, _CHUNK))
        self._pos = 0

    def bytes(self, n: int) -> bytes:
        out = b""
        while n:
            if self._pos >= len(self._buf):
                self._refill(n)
            take = min(n, len(self._buf) - self._pos)
            out += self._buf[self._pos:self._pos + take]
            self._pos += take
            n -= take
        return out

    def _u64(self, count: int) -> np.ndarray:
        return np.frombuffer(self.bytes(8 * count), dtype=np.uint64)

    # -- numpy-Generator subset ------------------------------------------
    def integers(self, low, high=None, size=None, dtype=np.int64):
        if high is None:
            low, high = 0, low
        span = int(high) - int(low)
        n = int(np.prod(size)) if size is not None else 1
        u = self._u64(n)
        vals = (u % np.uint64(span)).astype(np.int64) + int(low)
        vals = vals.astype(dtype)
        if size is None:
            return dtype(vals[0]) if not np.isscalar(vals[0]) else vals[0]
        return vals.reshape(size)

    def normal(self, loc=0.0, scale=1.0, size=None):
        n = int(np.prod(size)) if size is not None else 1
        m = (n + 1) // 2
        # 53-bit uniforms in (0, 1]
        u1 = ((self._u64(m) >> np.uint64(11)).astype(np.float64) + 1.0) \
            / 9007199254740992.0
        u2 = (self._u64(m) >> np.uint64(11)).astype(np.float64) \
            / 9007199254740992.0
        r = np.sqrt(-2.0 * np.log(u1))
        z = np.concatenate([r * np.cos(2 * np.pi * u2),
                            r * np.sin(2 * np.pi * u2)])[:n]
        out = loc + scale * z
        return out.reshape(size) if size is not None else out[0]

    def choice(self, a, size=None, replace=True):
        if np.isscalar(a):
            pool = np.arange(int(a))
        else:
            pool = np.asarray(a)
        n = int(np.prod(size)) if size is not None else 1
        if not replace:
            assert n <= len(pool)
            pool = pool.copy()
            # Fisher-Yates prefix shuffle
            for i in range(n):
                j = i + int(self._u64(1)[0] % np.uint64(len(pool) - i))
                pool[i], pool[j] = pool[j], pool[i]
            out = pool[:n]
        else:
            idx = (self._u64(n) % np.uint64(len(pool))).astype(np.int64)
            out = pool[idx]
        if size is None:
            return out[0]
        return out.reshape(size)
