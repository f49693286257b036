"""Key generation: secret/public/relinearization/Galois keys.

Port of ``moai_tpu/keys.py``.  Sampling stays on the host with the same
SHAKE-256 DRBG, drawn in the same order, so one seed gives bit-identical
keys in both packages.  Residues, Montgomery conversion and NTTs run on the
context's device; the JAX package's jitted digit step is eager here.

Hybrid key-switching keys: digit d's key encrypts P * gamma_d * target with
gamma_d = (Q/D_d) * [(Q/D_d)^{-1} mod D_d].  All key material is in NTT +
Montgomery form, shape [dnum, 2, L+K, N].

Every residue is an int32 tensor (``mod_arith``), switching keys too
(``dtype=torch.int32``, the default; the argument stays so that a caller
may ask for int64 copies, which the card's kernels refuse).  At N=2^16
the bootstrap's 107 Galois keys take 29.3 GB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import mod_arith as ma
from .params import Context, check_device
from .ntt import ntt
from .utils import debug


def _to_mont_host(res: np.ndarray, primes) -> np.ndarray:
    """Standard residues [..., L, N] -> Montgomery form (host, exact)."""
    out = np.empty_like(res, dtype=np.uint32)
    for i, q in enumerate(primes):
        r1 = (1 << 32) % q
        out[..., i, :] = (res[..., i, :].astype(np.uint64) * np.uint64(r1)
                          % np.uint64(q)).astype(np.uint32)
    return out


def _residues(coeffs: np.ndarray, primes) -> np.ndarray:
    """Signed int coefficients [..., N] -> standard residues [..., L, N]."""
    c = coeffs.astype(np.int64)
    out = np.empty(c.shape[:-1] + (len(primes), c.shape[-1]), dtype=np.uint32)
    for i, q in enumerate(primes):
        out[..., i, :] = (c % q).astype(np.uint32)
    return out


def residues_to_ntt(ctx: Context, res: torch.Tensor, lo: int, hi: int
                    ) -> torch.Tensor:
    """Standard residues [..., hi-lo, N] (int32) over primes [lo, hi) ->
    NTT Montgomery form, on the residues' device."""
    dv = ctx.dev
    mont = ma.to_mont(res, dv["q"][lo:hi].reshape(-1, 1),
                      dv["rinv"][lo:hi].reshape(-1, 1),
                      dv["r2"][lo:hi].reshape(-1, 1))
    return ntt(mont, dv["ntt"], limb_slice=(lo, hi))


def coeffs_to_ntt(ctx: Context, coeffs, lo: int, hi: int) -> torch.Tensor:
    """Signed integer coefficients [..., N] (|c| < 2^62) -> NTT Montgomery
    residues [..., hi-lo, N] over primes [lo, hi), computed on the
    context's device (the same values as ``_to_mont_host(_residues(...))``
    followed by the NTT)."""
    c = torch.as_tensor(np.asarray(coeffs, dtype=np.int64)).to(ctx.device)
    q = ctx.dev["q"][lo:hi].reshape(-1, 1)
    return residues_to_ntt(ctx, c[..., None, :].remainder(q).to(torch.int32),
                           lo, hi)


@dataclasses.dataclass
class SecretKey:
    coeffs: np.ndarray        # host ternary coefficients [N] (client-side)
    s_ntt: torch.Tensor       # [L+K, N] NTT Montgomery


@dataclasses.dataclass
class PublicKey:
    data: torch.Tensor        # [2, L, N] NTT Montgomery  (b = -(a s) + e, a)


@dataclasses.dataclass
class KSwitchKey:
    data: torch.Tensor        # [dnum, 2, q_limbs+K, N] NTT Montgomery
    # Q limbs present in ``data`` (None = the context's full L); a key
    # modulo a prefix of the chain is still a valid switching key
    q_limbs: int | None = None

    def to(self, device) -> "KSwitchKey":
        """The key on ``device`` (itself when it is there)."""
        data = self.data.to(device)
        return self if data is self.data else KSwitchKey(data, self.q_limbs)


@dataclasses.dataclass
class GaloisKeys:
    keys: dict                # galois element -> KSwitchKey
    perms: dict               # galois element -> np [N] NTT-domain gather index

    def to(self, device) -> "GaloisKeys":
        """The keys on ``device`` (themselves when they are there); the
        permutations stay host arrays."""
        keys = {g: k.to(device) for g, k in self.keys.items()}
        if all(keys[g] is k for g, k in self.keys.items()):
            return self
        return GaloisKeys(keys, self.perms)

    @property
    def q_limbs(self) -> int | None:
        """Common Q-limb count of all keys (uniform by construction)."""
        vals = {k.q_limbs for k in self.keys.values()}
        if len(vals) > 1:
            raise ValueError(f"GaloisKeys sliced non-uniformly: {vals}")
        return next(iter(vals)) if vals else None


def slice_kswitch(key: KSwitchKey, n_q: int, L: int) -> KSwitchKey:
    """Restrict a switching key to Q limbs [0:n_q] (+ all special limbs)."""
    cur = key.q_limbs if key.q_limbs is not None else L
    if n_q >= cur:
        return key
    d = key.data
    return KSwitchKey(torch.cat([d[..., :n_q, :], d[..., cur:, :]], dim=-2),
                      q_limbs=n_q)


def slice_galois(gks: GaloisKeys, n_q: int, L: int) -> GaloisKeys:
    return GaloisKeys(
        {g: slice_kswitch(k, n_q, L) for g, k in gks.keys.items()},
        gks.perms)


def power_of_two_steps(n_slots: int) -> list[int]:
    """The +-2^k rotation-step set (reaches any step with NAF)."""
    steps = set()
    k = 1
    while k < n_slots:
        steps.add(k)
        steps.add(n_slots - k)        # == -2^j mod n
        k <<= 1
    return sorted(steps)


class KeyGenerator:
    def __init__(self, ctx: Context, seed: int | None = 0, device="cuda"):
        self.ctx = ctx
        self.device = check_device(ctx, device)
        from .csprng import ShakeRng
        self.rng = ShakeRng(seed)
        self.sk = self._gen_secret()

    # -- samplers (host) --------------------------------------------------
    def _ternary(self) -> np.ndarray:
        N = self.ctx.cfg.N
        h = self.ctx.cfg.hamming_weight
        s = np.zeros(N, dtype=np.int64)
        if h and h > 0:
            idx = self.rng.choice(N, size=h, replace=False)
            s[idx] = self.rng.choice(np.array([-1, 1]), size=h)
        else:
            s = self.rng.integers(-1, 2, size=N).astype(np.int64)
        return s

    def _gauss(self) -> np.ndarray:
        return np.round(self.rng.normal(
            0.0, self.ctx.cfg.noise_std, self.ctx.cfg.N)).astype(np.int64)

    def _uniform_ntt(self, lo: int, hi: int) -> torch.Tensor:
        """Uniform poly sampled directly in the NTT domain, Montgomery form.
        Per prime, the 64-bit words of ``rng.integers(0, 2**62, N)`` (the
        same draw from the stream), reduced mod 2^62 and mod q on the
        device: the JAX package's values, without the host's passes over
        each word."""
        N = self.ctx.cfg.N
        raw = np.stack([self.rng._u64(N) for _ in range(hi - lo)])
        t = torch.from_numpy(raw.view(np.int64)).to(self.device)
        t.bitwise_and_((1 << 62) - 1)
        return t.remainder_(self.ctx.dev["q"][lo:hi].reshape(-1, 1)).to(
            torch.int32)

    def _q(self, lo: int, hi: int):
        dv = self.ctx.dev
        return dv["q"][lo:hi].reshape(-1, 1), dv["rinv"][lo:hi].reshape(-1, 1)

    # -- secret key -------------------------------------------------------
    def _gen_secret(self) -> SecretKey:
        s = self._ternary()
        nall = self.ctx.L + self.ctx.K
        return SecretKey(coeffs=s, s_ntt=coeffs_to_ntt(self.ctx, s, 0, nall))

    # -- public key -------------------------------------------------------
    @debug.spanned("keygen.public")
    def gen_public_key(self) -> PublicKey:
        L = self.ctx.L
        a = self._uniform_ntt(0, L)
        e_ntt = coeffs_to_ntt(self.ctx, self._gauss(), 0, L)
        q, rinv = self._q(0, L)
        b = ma.add_mod(ma.neg_mod(
            ma.mont_mul(a, self.sk.s_ntt[:L], q, rinv), q), e_ntt, q)
        return PublicKey(data=torch.stack([b, a]))

    # -- key-switching keys ----------------------------------------------
    def _gen_kswitch(self, target_ntt: torch.Tensor,
                     dtype: torch.dtype = torch.int32) -> KSwitchKey:
        """Key encrypting P*gamma_d*target per digit; target in NTT
        Montgomery form over the full basis [L+K, N], held as ``dtype``
        (int32, or int64 copies of the same values)."""
        ctx = self.ctx
        nall = ctx.L + ctx.K
        q, rinv = self._q(0, nall)
        P = ctx.P_int
        Q = 1
        for p in ctx.q_primes:
            Q *= p
        keys = []
        for lo, hi in ctx.digit_ranges:
            D = 1
            for i in range(lo, hi):
                D *= ctx.q_primes[i]
            hatD = Q // D
            gamma = hatD * pow(hatD % D, -1, D)                # mod Q
            # factor (P*gamma mod q_j) per limb, Montgomery; 0 on P limbs
            fac = np.zeros(nall, dtype=np.int32)
            for j, qj in enumerate(ctx.q_primes):
                fac[j] = (P % qj) * (gamma % qj) % qj * ((1 << 32) % qj) % qj
            facj = torch.from_numpy(fac).to(self.device).reshape(-1, 1)
            a = self._uniform_ntt(0, nall)
            e_ntt = coeffs_to_ntt(ctx, self._gauss(), 0, nall)
            b = ma.add_mod(ma.neg_mod(
                ma.mont_mul(a, self.sk.s_ntt, q, rinv), q), e_ntt, q)
            b = ma.add_mod(b, ma.mont_mul(target_ntt, facj, q, rinv), q)
            keys.append(torch.stack([b, a]).to(dtype))
        return KSwitchKey(data=torch.stack(keys))

    @debug.spanned("keygen.relin")
    def gen_relin_key(self, dtype: torch.dtype = torch.int32) -> KSwitchKey:
        q, rinv = self._q(0, self.ctx.L + self.ctx.K)
        s2 = ma.mont_mul(self.sk.s_ntt, self.sk.s_ntt, q, rinv)
        return self._gen_kswitch(s2, dtype)

    # -- Galois -----------------------------------------------------------
    def galois_perm(self, galois_elt: int) -> np.ndarray:
        """NTT-domain gather indices: out[k] = in[perm[k]] applies x->x^g;
        with index t <-> exponent 2t+1, perm[k] = ((g(2k+1) mod 2N) - 1)/2."""
        N = self.ctx.cfg.N
        k = np.arange(N, dtype=np.int64)
        return ((galois_elt * (2 * k + 1)) % (2 * N) - 1) // 2

    def galois_elt_rotation(self, steps: int) -> int:
        """Galois element rotating slots by ``steps`` (slot j <- j+steps)."""
        two_n = 2 * self.ctx.cfg.N
        return pow(5, steps % (self.ctx.cfg.N // 2), two_n)

    def galois_elt_conjugate(self) -> int:
        return 2 * self.ctx.cfg.N - 1

    @debug.spanned("keygen.galois")
    def gen_galois_keys(self, steps: list[int], conjugate: bool = False,
                        dtype: torch.dtype = torch.int32) -> GaloisKeys:
        """Keys for the exact rotation-step set, held as ``dtype``."""
        elts = [self.galois_elt_rotation(s) for s in steps]
        if conjugate:
            elts.append(self.galois_elt_conjugate())
        keys, perms = {}, {}
        for g in dict.fromkeys(elts):
            perm = self.galois_perm(g)
            # switching sigma_g(c1) needs a key for sigma_g(s): the same
            # NTT-domain permutation applied to s
            idx = torch.from_numpy(perm).to(self.device)
            keys[g] = self._gen_kswitch(self.sk.s_ntt[:, idx], dtype)
            perms[g] = perm
        return GaloisKeys(keys=keys, perms=perms)
