"""Host-side prime generation for the RNS modulus chain.

A verbatim copy of ``moai_tpu/primes.py``: the port imports nothing of the
JAX package, and tests/test_torch_mod_arith.py holds the two copies equal.

TPU-native design note: unlike SEAL's ``CoeffModulus::Create``
(reference: thirdparty/SEAL-4.1-bs/native/src/seal/modulus.cpp), which
produces 40-60 bit primes for 64-bit word arithmetic, this framework uses
primes strictly below 2**30 so that every residue fits a single uint32 lane
and a modular multiply costs ~9 int32 VPU multiplies (Montgomery, 16-bit
digit split).  Large CKKS scales are obtained by *composite* levels: a data
level is a pair of ~26-bit primes whose product plays the role of one
46-52 bit SEAL prime (rescaling simply divides by the two primes in
sequence).

All functions here run on host with Python integers (exact arithmetic).
"""

from __future__ import annotations

import math
from typing import Iterable


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3,317,044,064,679,887,385,961,981."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def ntt_primes_near(bits: float, two_n: int, count: int,
                    exclude: Iterable[int] = (), max_bits: int = 30,
                    direction: str = "down") -> list[int]:
    """Find ``count`` primes p ≡ 1 (mod two_n) with p ≈ 2**bits, p < 2**max_bits.

    ``direction`` controls the scan: "down" walks downward from 2**bits,
    "up" walks upward, "both" alternates to stay as close as possible.
    """
    assert bits <= max_bits, (bits, max_bits)
    target = int(round(2.0 ** bits))
    # first candidate k*two_n + 1 at or below target
    k0 = max((target - 1) // two_n, 1)
    excl = set(exclude)
    found: list[int] = []
    k_dn, k_up = k0, k0 + 1
    limit = (1 << max_bits) // two_n + 1
    while len(found) < count:
        cand = None
        if direction == "down":
            cand = k_dn * two_n + 1
            k_dn -= 1
            if k_dn < 1 and len(found) < count:
                direction = "up"  # fall through to upward scan
        elif direction == "up":
            if k_up > limit:
                raise RuntimeError(
                    f"prime pool exhausted: need {count} primes ~2^{bits} "
                    f"== 1 mod {two_n} below 2^{max_bits}")
            cand = k_up * two_n + 1
            k_up += 1
        else:  # both: pick whichever k is closer to k0
            if (k0 - k_dn) <= (k_up - k0) and k_dn >= 1:
                cand = k_dn * two_n + 1
                k_dn -= 1
            else:
                if k_up > limit:
                    raise RuntimeError("prime pool exhausted")
                cand = k_up * two_n + 1
                k_up += 1
        if cand is None or cand >= (1 << max_bits) or cand in excl:
            continue
        if is_prime(cand):
            found.append(cand)
            excl.add(cand)
    return found


def primitive_root_2n(p: int, two_n: int) -> int:
    """Minimal 2N-th primitive root of unity mod p (p ≡ 1 mod 2N).

    Mirrors the behaviour of SEAL's ``try_minimal_primitive_root``
    (reference: thirdparty/SEAL-4.1-bs/native/src/seal/util/numth.cpp) but
    any valid root works since all twiddle tables are derived consistently.
    """
    # find generator of the 2N-subgroup: g = x^((p-1)/2N) with order 2N
    exp = (p - 1) // two_n
    g = None
    for x in range(2, 1000):
        cand = pow(x, exp, p)
        # order divides two_n; check it is exactly two_n
        if pow(cand, two_n // 2, p) != 1:
            g = cand
            break
    if g is None:
        raise RuntimeError(f"no primitive 2N-th root found mod {p}")
    # minimize over odd powers (all primitive roots are g^odd)
    best = g
    cur = g
    g2 = g * g % p
    for _ in range(two_n // 2 - 1):
        cur = cur * g2 % p
        if cur < best:
            best = cur
    return best


def inv_mod(a: int, p: int) -> int:
    return pow(a, -1, p)
