"""Homomorphic evaluator: the workhorse of the scheme layer.

Port of ``moai_tpu/evaluator.py``.  Every op is eager PyTorch over
``Ciphertext`` data ``[..., n_polys, n_q, N]`` with Python scale/level
metadata, batched over leading axes.  Key switching is hybrid (dnum digits,
shared special primes).  Ciphertexts stay in NTT+Montgomery form; rescale
and key switching round-trip limbs through the coefficient domain with
``ntt``/``intt``, which on a CUDA tensor are the hand-written kernels.

The limb arithmetic goes through ``mod_arith``: on a CUDA tensor its
hand-written kernels (csrc/limb.cu: the elementwise family, the base
conversions of the key-switch decomposition and the mod-down, the
key-switch MAC with the hoisted rotations' gather folded in), on a CPU
tensor the plain torch ops.  Residues are int32 tensors on either device
(``mod_arith``); the plain loops accumulate a few canonical residues in
int64 and reduce once (each term is < 2^30, so a sum of up to 2^33 terms
cannot overflow); the result is the same canonical residue the JAX
package's pairwise ``add_mod`` chain gives.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mod_arith as ma
from .params import Context, check_device
from .ciphertext import Ciphertext, Plaintext
from .keys import KSwitchKey, GaloisKeys
from .ntt import ntt, intt


def _close(a: float, b: float, tol=2e-3) -> bool:
    """Scale compatibility: composite-pair rescaling drifts the scale by
    ~1e-4 per level; additions tolerate that drift."""
    return abs(a - b) <= tol * max(abs(a), abs(b))


def _require(cond: bool, msg) -> None:
    if not cond:
        raise ValueError(msg)


class Evaluator:
    def __init__(self, ctx: Context, relin_key: KSwitchKey | None = None,
                 galois_keys: GaloisKeys | None = None, device="cuda"):
        self.ctx = ctx
        self.device = check_device(ctx, device)
        self.dev = ctx.dev
        self.tbd = self.dev["ntt"]
        self.relin_key = relin_key
        self.galois_keys = galois_keys
        self._perm_cache = {}
        # optional observability hook: callable(op_name, result_ct), called
        # as each of the ops below returns (utils/debug.OpTrace)
        self.debug = None

    def _dbg(self, name: str, ct: Ciphertext) -> Ciphertext:
        if self.debug is not None:
            self.debug(name, ct)
        return ct

    # -- per-limb constants [n, 1] ------------------------------------------
    def _q(self, n_q):
        return self.dev["q"][:n_q].reshape(-1, 1)

    def _rinv(self, n_q):
        return self.dev["rinv"][:n_q].reshape(-1, 1)

    def _qt(self, n_q):
        """Moduli and R^-1 of the key-switching targets Q_l + P."""
        L = self.ctx.L
        q, rinv = self.dev["q"], self.dev["rinv"]
        return (torch.cat([q[:n_q], q[L:]]).reshape(-1, 1),
                torch.cat([rinv[:n_q], rinv[L:]]).reshape(-1, 1))

    def _check_add(self, op, a, b):
        _require(a.n_q == b.n_q, f"{op}: levels {a.n_q} vs {b.n_q}")
        _require(_close(a.scale, b.scale),
                 f"{op}: scales {a.scale:.6g} vs {b.scale:.6g} drift beyond "
                 f"the composite-pair tolerance; reconcile with match_scale")

    @staticmethod
    def _with_c0(a: Ciphertext, c0) -> Ciphertext:
        return a.with_data(torch.cat([c0.unsqueeze(-3), a.data[..., 1:, :, :]],
                                     dim=-3))

    # -- additive ops -----------------------------------------------------
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_add("add", a, b)
        _require(a.is_ntt and b.is_ntt, "add: operands must be in NTT form")
        return Ciphertext(ma.add_mod(a.data, b.data, self._q(a.n_q)),
                          a.scale, a.is_ntt)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_add("sub", a, b)
        return Ciphertext(ma.sub_mod(a.data, b.data, self._q(a.n_q)),
                          a.scale, a.is_ntt)

    def negate(self, a: Ciphertext) -> Ciphertext:
        return a.with_data(ma.neg_mod(a.data, self._q(a.n_q)))

    def add_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        self._check_add("add_plain", a, p)
        return self._with_c0(a, ma.add_mod(a.data[..., 0, :, :], p.data,
                                           self._q(a.n_q)))

    def sub_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        self._check_add("sub_plain", a, p)
        return self._with_c0(a, ma.sub_mod(a.data[..., 0, :, :], p.data,
                                           self._q(a.n_q)))

    # -- scalar constants ---------------------------------------------------
    def _const_residues_mont(self, value: float, scale: float, n_q: int):
        """round(value*scale) as per-limb Montgomery residues [n_q, 1]."""
        v = int(round(value * scale))
        out = [(v % q) * ((1 << 32) % q) % q for q in self.ctx.q_primes[:n_q]]
        return torch.tensor(out, dtype=torch.int32,
                            device=self.device).reshape(-1, 1)

    def add_const(self, a: Ciphertext, value: float) -> Ciphertext:
        c = self._const_residues_mont(value, a.scale, a.n_q)
        return self._with_c0(a, ma.add_mod(a.data[..., 0, :, :], c,
                                           self._q(a.n_q)))

    def mul_const(self, a: Ciphertext, value: float,
                  const_scale: float | None = None) -> Ciphertext:
        """Multiply by a scalar encoded at ``const_scale`` (default: the
        pair product at the current level, so one level rescale restores
        the scale)."""
        const_scale = const_scale if const_scale is not None else \
            self.level_pair_scale(a.n_q)
        c = self._const_residues_mont(value, const_scale, a.n_q)
        out = ma.mont_mul(a.data, c, self._q(a.n_q), self._rinv(a.n_q))
        return Ciphertext(out, a.scale * const_scale, a.is_ntt)

    def level_pair_scale(self, n_q: int) -> float:
        """Product of the top prime pair at this level."""
        return float(self.ctx.q_primes[n_q - 1]) * \
            float(self.ctx.q_primes[n_q - 2])

    # -- multiplicative ops ----------------------------------------------
    def multiply_plain(self, a: Ciphertext, p: Plaintext) -> Ciphertext:
        _require(a.n_q == p.n_q, f"multiply_plain: levels {a.n_q} vs {p.n_q}")
        out = ma.mont_mul(a.data, p.data.unsqueeze(-3), self._q(a.n_q),
                          self._rinv(a.n_q))
        return self._dbg("multiply_plain",
                         Ciphertext(out, a.scale * p.scale, a.is_ntt))

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Dyadic ct*ct product -> 3-poly ciphertext."""
        _require(a.n_q == b.n_q and a.n_polys == 2 and b.n_polys == 2,
                 "multiply: two 2-poly ciphertexts at one level")
        q, rinv = self._q(a.n_q), self._rinv(a.n_q)
        a0, a1 = a.data[..., 0, :, :], a.data[..., 1, :, :]
        b0, b1 = b.data[..., 0, :, :], b.data[..., 1, :, :]
        c0 = ma.mont_mul(a0, b0, q, rinv)
        c1 = ma.add_mod(ma.mont_mul(a0, b1, q, rinv),
                        ma.mont_mul(a1, b0, q, rinv), q)
        c2 = ma.mont_mul(a1, b1, q, rinv)
        return self._dbg("multiply", Ciphertext(
            torch.stack([c0, c1, c2], dim=-3), a.scale * b.scale, True))

    def square(self, a: Ciphertext) -> Ciphertext:
        q, rinv = self._q(a.n_q), self._rinv(a.n_q)
        a0, a1 = a.data[..., 0, :, :], a.data[..., 1, :, :]
        c0 = ma.mont_mul(a0, a0, q, rinv)
        c1 = ma.mont_mul(a0, a1, q, rinv)
        c1 = ma.add_mod(c1, c1, q)
        c2 = ma.mont_mul(a1, a1, q, rinv)
        return Ciphertext(torch.stack([c0, c1, c2], dim=-3),
                          a.scale * a.scale, True)

    def relinearize(self, a: Ciphertext) -> Ciphertext:
        _require(a.n_polys == 3 and self.relin_key is not None,
                 "relinearize: a 3-poly ciphertext and a relin key")
        ks0, ks1 = self._switch_key(a.data[..., 2, :, :], self.relin_key,
                                    a.n_q)
        q = self._q(a.n_q)
        c0 = ma.add_mod(a.data[..., 0, :, :], ks0, q)
        c1 = ma.add_mod(a.data[..., 1, :, :], ks1, q)
        return self._dbg("relinearize", Ciphertext(
            torch.stack([c0, c1], dim=-3), a.scale, True))

    def multiply_relin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.relinearize(self.multiply(a, b))

    # -- rescale / mod switch --------------------------------------------
    def rescale(self, a: Ciphertext) -> Ciphertext:
        """Drop the top prime, dividing the message by it."""
        n_q = a.n_q
        ell = n_q - 1
        _require(ell >= 1, "rescale: no prime left to drop")
        dv = self.dev
        qe = int(self.ctx.q_primes[ell])
        # last limb -> coefficients -> true value u = [c_ell + qe/2]
        last = intt(a.data[..., ell:ell + 1, :], self.tbd,
                    limb_slice=(ell, ell + 1))
        t = ma.from_mont(last, qe, int(self.ctx.ntt.rinv[ell]))
        u = ma.add_mod(t, qe >> 1, qe)
        # u to each remaining modulus (to_mont takes u >= q_j), minus the
        # rounding half per coefficient, then back to the NTT domain
        qj, rinvj = self._q(ell), self._rinv(ell)
        uj = ma.to_mont(u, qj, rinvj, dv["r2"][:ell].reshape(-1, 1))
        uj = ma.sub_mod(uj, dv["resc_half_mod"][ell, :ell].reshape(-1, 1), qj)
        u_ntt = ntt(uj, self.tbd, limb_slice=(0, ell))
        out = ma.sub_mont_mul(a.data[..., :ell, :], u_ntt,
                              dv["resc_qlinv_mont"][ell, :ell].reshape(-1, 1),
                              qj, rinvj)
        return self._dbg("rescale", Ciphertext(out, a.scale / qe, True))

    def rescale_pair(self, a: Ciphertext) -> Ciphertext:
        """One level rescale = two single-prime rescales (composite scale)."""
        return self.rescale(self.rescale(a))

    def mod_drop(self, a: Ciphertext, n_primes: int = 1) -> Ciphertext:
        """Drop top primes without scaling."""
        _require(a.n_q - n_primes >= 1, "mod_drop: below the last prime")
        return a.with_data(a.data[..., : a.n_q - n_primes, :])

    def mod_drop_to(self, a: Ciphertext, n_q: int) -> Ciphertext:
        _require(n_q <= a.n_q, f"mod_drop_to: {n_q} above {a.n_q}")
        return self._dbg("mod_drop_to", a.with_data(a.data[..., :n_q, :]))

    def mod_drop_level(self, a: Ciphertext, n_levels: int = 1) -> Ciphertext:
        """Drop whole composite levels (pairs of primes)."""
        return self.mod_drop(a, 2 * n_levels)

    def plain_mod_drop_to(self, p: Plaintext, n_q: int) -> Plaintext:
        return Plaintext(p.data[..., :n_q, :], p.scale, p.is_ntt)

    # -- key switching core ----------------------------------------------
    def _active_digits(self, n_q: int) -> int:
        return sum(1 for lo, hi in self.ctx.digit_ranges if lo < n_q)

    def _ks_decompose(self, poly_ntt, n_q: int):
        """Digit-decompose + base-extend + NTT: [..., n_q, N] NTT Montgomery
        -> y [..., D, n_t, N] (NTT Montgomery over Q_l + P).  The
        rotation-independent half of key switching (hoisted rotations reuse
        it)."""
        ctx, dv = self.ctx, self.dev
        L, K = ctx.L, ctx.K
        nall = L + K
        qt, rinvt = self._qt(n_q)
        D = self._active_digits(n_q)
        c = intt(poly_ntt, self.tbd, limb_slice=(0, n_q))
        # fast base extension y_t = sum_i lam_i * hat_i (Montgomery out) of
        # each digit's alpha limbs; past n_q the hat-inverse table is zero
        hat = dv["ks_hat_mm"][n_q, :D]                  # [D, alpha, nall]
        hat_t = torch.cat([hat[..., :n_q], hat[..., L:]], dim=-1)
        y = ma.base_conv(c, dv["ks_q_pad"], dv["ks_rinv_pad"],
                         dv["ks_hatinv_mont"][n_q, :D], hat_t, qt, rinvt)
        y_q = ntt(y[..., :n_q, :], self.tbd, limb_slice=(0, n_q))
        y_p = ntt(y[..., n_q:, :], self.tbd, limb_slice=(L, nall))
        return torch.cat([y_q, y_p], dim=-2)            # [..., D, n_t, N]

    def _ks_mac_moddown(self, y, keys, q_limbs, n_q: int, perm=None):
        """MAC the decomposition y [..., D, n_t, N] against the key rows of
        ``keys`` (``mod_arith.ks_mac``: one key, or with perm [R, N] one per
        rotation) and mod-down by P -> (d0, d1), each [..., n_q, N] (with
        perm [R, ..., n_q, N])."""
        q_limbs = q_limbs if q_limbs is not None else self.ctx.L
        _require(n_q <= q_limbs, f"key holds {q_limbs} Q limbs, data {n_q}")
        qt, rinvt = self._qt(n_q)
        acc0, acc1 = ma.ks_mac(y, keys, q_limbs, qt, rinvt, perm)
        return self._mod_down_p(acc0, n_q), self._mod_down_p(acc1, n_q)

    def _switch_key(self, poly_ntt, key: KSwitchKey, n_q: int):
        """Hybrid key switch: decompose + extend + NTT once, MAC, mod-down."""
        y = self._ks_decompose(poly_ntt, n_q)
        return self._ks_mac_moddown(y, key.data, key.q_limbs, n_q)

    def _mod_down_p(self, u, n_q: int):
        """Divide a [..., n_q+K, N] NTT poly by P, dropping the P limbs."""
        dv = self.dev
        L, K = self.ctx.L, self.ctx.K
        u_q = u[..., :n_q, :]
        u_p = u[..., n_q:, :]
        cp = intt(u_p, self.tbd, limb_slice=(L, L + K))
        qj, rinvj = self._q(n_q), self._rinv(n_q)
        w = ma.base_conv(cp, dv["q"][L:], dv["rinv"][L:],
                         dv["pdown_hatinv_mont"],
                         dv["pdown_hat_modq_mm"][None, :, :n_q], qj,
                         rinvj)[..., 0, :, :]
        w_ntt = ntt(w, self.tbd, limb_slice=(0, n_q))
        pinv = dv["pdown_pinv_mont"][:n_q].reshape(-1, 1)
        return ma.sub_mont_mul(u_q, w_ntt, pinv, qj, rinvj)

    # -- Galois / rotations ----------------------------------------------
    def _perm(self, g: int) -> torch.Tensor:
        if g not in self._perm_cache:
            _require(self.galois_keys is not None
                     and g in self.galois_keys.perms,
                     f"missing galois key for element {g}")
            self._perm_cache[g] = torch.from_numpy(
                np.asarray(self.galois_keys.perms[g], np.int64)).to(self.device)
        return self._perm_cache[g]

    def apply_galois(self, a: Ciphertext, g: int) -> Ciphertext:
        """sigma_g, then key-switch back to the canonical key."""
        _require(a.n_polys == 2, "apply_galois: a 2-poly ciphertext")
        d = torch.index_select(a.data, -1, self._perm(g))
        c0, c1 = d[..., 0, :, :], d[..., 1, :, :]
        ks0, ks1 = self._switch_key(c1, self.galois_keys.keys[g], a.n_q)
        q = self._q(a.n_q)
        return self._dbg("apply_galois", Ciphertext(
            torch.stack([ma.add_mod(c0, ks0, q), ks1], dim=-3), a.scale, True))

    def _naf_digits(self, v: int) -> list[int]:
        """Non-adjacent form: signed powers of two summing to v."""
        out = []
        bit = 0
        while v:
            if v & 1:
                d = 2 - (v & 3)               # v mod 4 == 1 -> +1, == 3 -> -1
                out.append(d << bit)
                v -= d
            v >>= 1
            bit += 1
        return out

    def rotate(self, a: Ciphertext, steps: int) -> Ciphertext:
        """Rotate slots by ``steps``; without the exact key, the cheapest
        available signed power-of-two decomposition (NAF of ``steps`` and
        of ``steps - n``, then plain binary)."""
        n = self.ctx.cfg.N // 2
        steps = steps % n
        if steps == 0:
            return a
        two_n = 2 * self.ctx.cfg.N
        g = pow(5, steps, two_n)
        if self.galois_keys is not None and g in self.galois_keys.keys:
            return self.apply_galois(a, g)
        best = None
        cands = [self._naf_digits(steps), self._naf_digits(steps - n),
                 [1 << b for b in range(n.bit_length())
                  if steps & (1 << b)]]
        for digits in cands:
            elts = [pow(5, d % n, two_n) for d in digits]
            if all(e in self.galois_keys.keys for e in elts):
                if best is None or len(elts) < len(best):
                    best = elts
        _require(best is not None,
                 f"no galois key chain for rotation step {steps}")
        out = a
        for e in best:
            out = self.apply_galois(out, e)
        return out

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        return self.apply_galois(a, 2 * self.ctx.cfg.N - 1)

    def rotate_hoisted(self, a: Ciphertext, steps: list[int],
                       chunk: int | None = None) -> Ciphertext:
        """Rotate ``a`` by every step in ``steps`` at once; returns a
        ciphertext with a new leading axis R = len(steps).  The
        decomposition runs once; each rotation is a gather of its digits
        plus a MAC with that rotation's key.  ``chunk`` rotations are
        processed at a time."""
        _require(a.n_polys == 2, "rotate_hoisted: a 2-poly ciphertext")
        two_n = 2 * self.ctx.cfg.N
        n = self.ctx.cfg.N // 2
        elts = [pow(5, s % n, two_n) for s in steps]
        n_q = a.n_q
        q = self._q(n_q)
        y = self._ks_decompose(a.data[..., 1, :, :], n_q)   # [..., D, n_t, N]
        chunk = chunk or len(steps)
        q_limbs = self.galois_keys.q_limbs
        outs = []
        for s0 in range(0, len(steps), chunk):
            es = elts[s0:s0 + chunk]
            p = torch.stack([self._perm(g) for g in es])    # [R, N]
            # digits of sigma_g(c1) = sigma_g(digits of c1): the MAC reads
            # y through each rotation's permutation
            d0, d1 = self._ks_mac_moddown(
                y, [self.galois_keys.keys[g].data for g in es], q_limbs,
                n_q, perm=p)
            c0 = a.data[..., 0, :, :][..., p].movedim(-2, 0)
            outs.append(torch.stack([ma.add_mod(c0, d0, q), d1], dim=-3))
        return self._dbg("rotate_hoisted", Ciphertext(
            torch.cat(outs) if len(outs) > 1 else outs[0], a.scale, True))

    # -- integer & per-column constant helpers -----------------------------
    def mul_int(self, a: Ciphertext, n: int) -> Ciphertext:
        """Multiply by a small positive integer via doubling adds: no level,
        no scale change."""
        _require(n >= 1, "mul_int: n >= 1")
        q = self._q(a.n_q)
        acc = None
        cur = a.data
        while n:
            if n & 1:
                acc = cur if acc is None else ma.add_mod(acc, cur, q)
            n >>= 1
            if n:
                cur = ma.add_mod(cur, cur, q)
        return a.with_data(acc)

    def mul_const_to(self, a: Ciphertext, value: float,
                     target_scale: float) -> Ciphertext:
        """Multiply by a scalar encoded so that one level rescale lands the
        result exactly at ``target_scale``."""
        pair = self.level_pair_scale(a.n_q)
        return self.mul_const(a, value,
                              const_scale=target_scale * pair / a.scale)

    def _const_vec_residues_mont(self, values, scale: float, n_q: int):
        """Per-leading-batch scalar constants: values [C] -> Montgomery
        residues [C, 1, n_q, 1]."""
        v = np.round(np.asarray(values, np.float64) * scale).astype(object)
        out = np.empty((len(v), n_q), dtype=np.int32)
        for i in range(n_q):
            q = self.ctx.q_primes[i]
            r = (1 << 32) % q
            out[:, i] = [(int(x) % q) * r % q for x in v]
        return torch.from_numpy(out).to(self.device)[:, None, :, None]

    def mul_const_vec(self, a: Ciphertext, values,
                      target_scale: float | None = None) -> Ciphertext:
        """Per-column scalar multiply: a.data [C, P, n_q, N] x values [C]."""
        pair = self.level_pair_scale(a.n_q)
        target_scale = target_scale if target_scale is not None else a.scale
        const_scale = target_scale * pair / a.scale
        c = self._const_vec_residues_mont(values, const_scale, a.n_q)
        out = ma.mont_mul(a.data, c, self._q(a.n_q), self._rinv(a.n_q))
        return Ciphertext(out, a.scale * const_scale, a.is_ntt)

    def add_const_vec(self, a: Ciphertext, values) -> Ciphertext:
        c = self._const_vec_residues_mont(values, a.scale, a.n_q)[:, 0]
        return self._with_c0(a, ma.add_mod(a.data[..., 0, :, :], c,
                                           self._q(a.n_q)))

    def align(self, a: Ciphertext, b: Ciphertext
              ) -> tuple[Ciphertext, Ciphertext]:
        """Drop the deeper operand's extra primes so both share n_q."""
        if a.n_q > b.n_q:
            a = self.mod_drop_to(a, b.n_q)
        elif b.n_q > a.n_q:
            b = self.mod_drop_to(b, a.n_q)
        return a, b

    def match_scale(self, a: Ciphertext, target_scale: float) -> Ciphertext:
        """Bring ``a`` to exactly ``target_scale`` with a constant 1.0
        encoded at the reconciling scale (spends one level)."""
        if abs(a.scale - target_scale) <= 1e-9 * target_scale:
            return a
        return self.rescale_pair(self.mul_const_to(a, 1.0, target_scale))

    def mul_relin_rescale(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """One composite-level ct*ct multiply (align, mul, relin, rescale)."""
        a, b = self.align(a, b)
        return self.rescale_pair(self.relinearize(self.multiply(a, b)))

    def square_rescale(self, a: Ciphertext) -> Ciphertext:
        return self.rescale_pair(self.relinearize(self.square(a)))

    def with_scale(self, a: Ciphertext, scale: float, *,
                   reason: str) -> Ciphertext:
        """Explicit scale reinterpretation; ``reason`` documents why a raw
        override is sound at the call site."""
        _require(bool(reason) and isinstance(reason, str),
                 "with_scale requires a justification string")
        return Ciphertext(a.data, float(scale), a.is_ntt)
