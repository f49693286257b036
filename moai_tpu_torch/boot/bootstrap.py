"""CKKS bootstrapping: ModRaise -> CoeffToSlot -> EvalMod x2 -> SlotToCoeff.

Port of ``moai_tpu/boot/bootstrap.py`` (``Bootstrapper``, ``make_refresh``):

- ModRaise composes the n_q0 bottom limbs with a float32 CRT-quotient
  estimate (exact up to +-1 multiple of q0, absorbed by EvalMod's +-K
  range); the estimate's products, two-term sum, round-half-to-even and
  cast are the JAX package's, so the raised residues are bit-identical.
  The conversion itself is ``mod_arith.base_conv`` (a kernel on the
  card); the estimate stays torch ops, so it rounds as on the CPU.
- CoeffToSlot/SlotToCoeff are BSGS levels over the diagonals of
  ``boot/linear.py`` (dense at n <= 512, else radix-factored and grouped),
  with q0/(2*pi*Delta) and the output scale folded into the last
  SlotToCoeff level's diagonals.
- Multiplication by i is a free negacyclic monomial multiply (X^(N/2)).

Every diagonal is encoded once, when the Bootstrapper is built, at the
level it will meet; only the last SlotToCoeff level, whose diagonals carry
the input scale through alpha, is encoded at its first use for each input
scale (``linear.encode_diagonals``).  The JAX package's machinery for
passing plaintexts into a jitted body (``collect_lt``, ``_pt_source``,
``lt=``) has no counterpart in eager PyTorch.
"""

from __future__ import annotations

import copy
import time
import warnings
from typing import Callable

import numpy as np
import torch

from .. import mod_arith as ma
from ..ciphertext import Ciphertext
from ..encoder import Encoder
from ..evaluator import Evaluator
from ..ntt import ntt, intt
from ..utils import debug
from .linear import (apply_diagonals, encode_diagonals, matrix_diagonals,
                     bsgs_steps, c2s_matrix, s2c_matrix, c2s_apply_levels,
                     s2c_apply_levels, group_apply_levels)
from .evalmod import ModReducer

# The default ModReducer's cosine degree: 63, where the JAX package fits
# 59.  Both take the same depth (the Chebyshev ladder reaches T_32 either
# way).  EvalMod's error at the integer centres t = I, where the messages
# sit (ModReducer.centre_error), is the same in the real and the imaginary
# branch, so its mean over the coefficients adds coherently through
# SlotToCoeff into the imaginary parts of the slots nearest rotation 0, an
# error that grows with N (coherent_error_bound).  Degree 59 leaves max |b|
# 5.6e-8: at N = 2^16 on flagship_config an H100 measured 1.16e-2 in the
# imaginary parts.  Degree 63 leaves 6.6e-10 (a bound of 1.1e-3 there),
# and the H100 measured 8.4e-5 with it.
EVALMOD_DEGREE = 63


class Bootstrapper:
    @debug.spanned("bootstrapper.init")
    def __init__(self, ev: Evaluator, encoder: Encoder,
                 mod_reducer: ModReducer | None = None,
                 m_bound: float = 1.0, n_out: int | None = None,
                 lt_group: int | None = None,
                 arcsin_deg: int | None = None,
                 evalmod_degree: int = EVALMOD_DEGREE):
        """``lt_group``: 0 = dense single-level CoeffToSlot/SlotToCoeff
        (1 level each, n diagonal plaintexts — test scale only); k>0 =
        radix-factored levels grouped k butterflies per level (~2^k
        diagonals per level).  Default: dense for n <= 512, else
        ceil(log2 n / 3) butterflies per level (3 levels each).
        ``evalmod_degree``: the degree of the default ModReducer's cosine
        fit (the JAX package's is 59; see ``EVALMOD_DEGREE``)."""
        self.ev, self.encoder = ev, encoder
        ctx = ev.ctx
        self.ctx = ctx
        self.q0 = float(ctx.q0_product)
        eps = m_bound * ctx.scale / self.q0
        if arcsin_deg is None:
            # wide physical intervals (|m| >> 1) leave an O(eps^3) residual
            # from the linearized arcsin — switch on the cubic correction
            arcsin_deg = 3 if eps > 2.0 ** -7 else 1
        self.mr = mod_reducer if mod_reducer is not None else \
            ModReducer(K=25, eps=max(eps, 2.0 ** -10),
                       degree=evalmod_degree, arcsin_deg=arcsin_deg)
        n = encoder.slots
        logn = n.bit_length() - 1
        if lt_group is None:
            lt_group = 0 if n <= 512 else -(-logn // 3)
        self.lt_group = lt_group
        if lt_group == 0:
            self.c2s_levels = [matrix_diagonals(c2s_matrix(encoder))]
            self.s2c_levels = [matrix_diagonals(s2c_matrix(encoder))]
        else:
            self.c2s_levels = group_apply_levels(c2s_apply_levels(encoder),
                                                 lt_group)
            self.s2c_levels = group_apply_levels(s2c_apply_levels(encoder),
                                                 lt_group)
        self._build_modraise_tables()
        self._imono = None
        self.n_out = n_out
        # called with a stage's name after each stage of a bootstrap
        # (ModRaise, each CoeffToSlot level, each EvalMod, each
        # SlotToCoeff level): a timing hook for the caller
        self.on_stage: Callable[[str], None] | None = None
        # encoded diagonals by (kind, level, n_q, alpha); the levels meet
        # fixed levels, so all but the alpha-folded one are encoded here;
        # encode_s sums the host seconds spent encoding
        self._pts: dict = {}
        self.encode_s = 0.0
        L = ctx.L
        for i in range(len(self.c2s_levels)):
            self._encoded("c2s", i, L - 2 * i)
        n_s2c = L - 2 * (len(self.c2s_levels) + self.mr.levels)
        for i in range(len(self.s2c_levels) - 1):
            if n_s2c - 2 * i >= ctx.n_q0 + 2:
                self._encoded("s2c", i, n_s2c - 2 * i)

    def to(self, device, ev: Evaluator | None = None) -> "Bootstrapper":
        """This Bootstrapper's replica on ``device``: its evaluator
        (``Evaluator.to``, or ``ev``, an evaluator already there), its
        encoded diagonals and ModRaise tables moved there, nothing
        recomputed; itself when it is there."""
        ev = self.ev.to(device) if ev is None else ev
        if ev is self.ev:
            return self
        dev = ev.device
        out = copy.copy(self)
        out.ev, out.encoder, out.ctx = ev, self.encoder.to(dev), ev.ctx
        out._pts = {k: {d: t.to(dev) for d, t in pts.items()}
                    for k, pts in self._pts.items()}
        for name in ("_mr_hatinv", "_mr_hat_mm", "_mr_q0_mm", "_mr_qinv_f"):
            setattr(out, name, getattr(self, name).to(dev))
        out._imono = None if self._imono is None else self._imono.to(dev)
        return out

    # -- key planning ------------------------------------------------------
    def galois_steps(self) -> list[int]:
        n = self.encoder.slots
        steps: set[int] = set()
        for lev in self.c2s_levels + self.s2c_levels:
            steps |= set(bsgs_steps(sorted(lev.keys()), n))
        return sorted(steps)

    @property
    def levels(self) -> int:
        """Composite levels consumed: c2s + evalmod + s2c."""
        return len(self.c2s_levels) + self.mr.levels + len(self.s2c_levels)

    def coherent_error_bound(self) -> float:
        """The largest slot error EvalMod's error at the integer centres
        (``ModReducer.centre_error``) can add coherently, at m_bound 1: the
        same bias b in every coefficient of both branches, u = (1 + i) b,
        reaches slot 0 through its row sum (1 + i) N / pi as 2i b N / pi,
        times q0 / (2 pi Delta) from SlotToCoeff."""
        b = float(np.abs(self.mr.centre_error()).max())
        return 2 * b * self.ctx.cfg.N / np.pi * self.q0 / (
            2 * np.pi * self.ctx.scale)

    # -- plaintext diagonals -------------------------------------------------
    def _encoded(self, kind: str, i: int, n_q: int,
                 alpha: float | None = None) -> dict:
        """Level i of kind "c2s"/"s2c" encoded at level n_q (times alpha),
        from the cache or encoded now; one alpha is kept per level."""
        key = (kind, i, n_q, alpha)
        pts = self._pts.get(key)
        if pts is None:
            t0 = time.perf_counter()
            if alpha is not None:
                for k in [k for k in self._pts if k[:2] == (kind, i)]:
                    del self._pts[k]
            lev = (self.c2s_levels if kind == "c2s" else self.s2c_levels)[i]
            pts = encode_diagonals(self.ctx, self.encoder, lev,
                                   self.ev.level_pair_scale(n_q), alpha)
            self._pts[key] = pts
            self.encode_s += time.perf_counter() - t0
        return pts

    # -- ModRaise ----------------------------------------------------------
    def _build_modraise_tables(self):
        ctx = self.ctx
        n0, L = ctx.n_q0, ctx.L
        primes = ctx.q_primes
        q0 = ctx.q0_product
        hatinv = np.empty(n0, np.int32)
        hat_mm = np.empty((n0, L), np.int32)
        q0_mm = np.empty(L, np.int32)
        for i in range(n0):
            qi = primes[i]
            hat = q0 // qi
            hatinv[i] = pow(hat % qi, -1, qi) * (1 << 32) % qi
            for j in range(L):
                qj = primes[j]
                hat_mm[i, j] = (hat % qj) * pow(2, 64, qj) % qj
        for j in range(L):
            qj = primes[j]
            q0_mm[j] = (q0 % qj) * pow(2, 64, qj) % qj
        dev = ctx.device
        self._mr_hatinv = torch.from_numpy(hatinv).to(dev).reshape(-1, 1)
        self._mr_hat_mm = torch.from_numpy(hat_mm).to(dev)
        self._mr_q0_mm = torch.from_numpy(q0_mm).to(dev)
        self._mr_qinv_f = torch.from_numpy(
            np.array([1.0 / primes[i] for i in range(n0)], np.float32)
        ).to(dev).reshape(-1, 1)

    def modraise(self, ct: Ciphertext) -> Ciphertext:
        """ct at the bottom n_q0 primes -> full chain; message becomes
        m*Delta + q0*I."""
        n0, L = self.ctx.n_q0, self.ctx.L
        if ct.n_q != n0:
            raise ValueError(f"modraise: input at {ct.n_q} limbs, not {n0}")
        lam = self._modraise_lift(ct.data, 0, n0)
        return Ciphertext(self._modraise_convert(lam, 0, L), ct.scale, True)

    def _modraise_lift(self, x, lo: int, hi: int):
        """ModRaise's first half on input limbs [lo, hi) of the n_q0 (NTT
        form): lam_i = [c_i * (q0/q_i)^-1] mod q_i, true residues."""
        dv, tbd = self.ev.dev, self.ev.tbd
        q = dv["q"][lo:hi].reshape(-1, 1)
        rinv = dv["rinv"][lo:hi].reshape(-1, 1)
        c = intt(x, tbd, limb_slice=(lo, hi))
        return ma.from_mont(ma.mont_mul(c, self._mr_hatinv[lo:hi], q, rinv),
                            q, rinv)                       # [.., P, n, N]

    def _modraise_convert(self, lam, lo: int, hi: int):
        """ModRaise's second half: all n_q0 lam [..., n_q0, N] converted to
        output limbs [lo, hi) of the full chain, less k * q0 with k from the
        float32 CRT estimate, back to the NTT domain."""
        dv = self.ev.dev
        f = torch.sum(lam.to(torch.float32) * self._mr_qinv_f, dim=-2)
        k = torch.round(f).to(torch.int32)                 # [..., P, N]
        acc = ma.base_conv(lam, None, None, None,
                           self._mr_hat_mm[None, :, lo:hi],
                           dv["q"][lo:hi].reshape(-1, 1),
                           dv["rinv"][lo:hi].reshape(-1, 1), k=k,
                           kq=self._mr_q0_mm[lo:hi])[..., 0, :, :]
        return ntt(acc, self.ev.tbd, limb_slice=(lo, hi))

    # -- multiply by i (free monomial X^n) ---------------------------------
    def _i_mono(self, n_q: int) -> torch.Tensor:
        if self._imono is None:
            ctx = self.ctx
            N = ctx.cfg.N
            coeffs = torch.zeros((ctx.L, N), dtype=torch.int32,
                                 device=ctx.device)
            coeffs[:, N // 2] = ctx.dev["r1"][:ctx.L]     # Montgomery 1
            self._imono = ntt(coeffs, self.ev.tbd, limb_slice=(0, ctx.L))
        return self._imono[:n_q]

    def mul_i(self, ct: Ciphertext) -> Ciphertext:
        """Multiply all slots by i = X^(N/2): exact, free (no key switch,
        no level, no scale change)."""
        ev = self.ev
        return ct.with_data(ma.mont_mul(ct.data, self._i_mono(ct.n_q),
                                        ev._q(ct.n_q), ev._rinv(ct.n_q)))

    # -- full pipeline ------------------------------------------------------
    def _stage(self, name: str) -> None:
        if self.on_stage is not None:
            self.on_stage(name)

    def _linear(self, kind: str, i: int, ct: Ciphertext,
                alpha: float | None = None) -> Ciphertext:
        """Level i of CoeffToSlot ("c2s") or SlotToCoeff ("s2c") applied
        to ct, with its diagonals encoded at ct's level (times alpha)."""
        lev = (self.c2s_levels if kind == "c2s" else self.s2c_levels)[i]
        return apply_diagonals(self.ev, self.encoder, ct, lev,
                               encoded=self._encoded(kind, i, ct.n_q, alpha))

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        ev, ctx = self.ev, self.ctx
        delta_in = ct.scale
        with debug.span("modraise"):
            z = self.modraise(ct)
        self._stage("ModRaise")
        for i in range(len(self.c2s_levels)):
            with debug.span(f"coeff_to_slot.{i}"):
                z = self._linear("c2s", i, z)
            self._stage(f"CoeffToSlot {i}")
        with debug.span("evalmod.real"):
            # reinterpret: slots now hold t = m*Delta_in/q0 + I at scale q0
            # (coefficients arrive bit-reversed in the factored path;
            # EvalMod is pointwise and SlotToCoeff consumes the same order,
            # so the permutation cancels)
            t = ev.with_scale(z, self.q0 * z.scale / delta_in,
                              reason="ModRaise: slots hold m*Delta/q0 + I")
            del z
            tc = ev.conjugate(t)
            t_r = ev.add(t, tc)                                # 2*Re(t)
            t_i = self.mul_i(ev.sub(tc, t))                    # 2*Im(t)
            del t, tc
            y_r = self.mr(ev, t_r, pre_scale=0.5)
            del t_r
        self._stage("EvalMod real")
        with debug.span("evalmod.imag"):
            y_i = self.mr(ev, t_i, pre_scale=0.5)
            del t_i
        self._stage("EvalMod imag")
        w = ev.add(y_r, self.mul_i(y_i))
        del y_r, y_i
        # fold q0/(2*pi*Delta_in) and the output scale into the LAST
        # SlotToCoeff level's diagonals
        alpha = ctx.scale * self.q0 / (2 * np.pi * delta_in * w.scale)
        out = w
        last = len(self.s2c_levels) - 1
        for i in range(len(self.s2c_levels)):
            with debug.span(f"slot_to_coeff.{i}"):
                out = self._linear("s2c", i, out,
                                   alpha if i == last else None)
            self._stage(f"SlotToCoeff {i}")
        out = ev.with_scale(out, ctx.scale,
                            reason="SlotToCoeff folded alpha into last LT")
        if self.n_out is not None and out.n_q > self.n_out:
            out = ev.mod_drop_to(out, self.n_out)
        return out


def make_refresh(bt: Bootstrapper, m_bound: float = 1.0):
    """Adapt a Bootstrapper to the model layers' ``refresh(ct, n_q)``
    callback (models/bert.py).  ``m_bound``: values are reinterpreted to
    |m| <= 1 by declaring scale*m_bound before the bootstrap and undoing
    it after — free, but the PHYSICAL EvalMod interval width is
    |v|/q0 = |m|*Delta/q0, so callers must keep |m|*Delta within the
    ModReducer's eps (fold real normalization into adjacent plaintext
    constants: LayerNorm gamma before a bootstrap, the next matmul's
    weights after)."""
    ev = bt.ev

    @debug.spanned("refresh")
    def refresh(ct, n_q):
        # Deep squaring chains drift the tracked composite scale; the
        # bootstrap's message precision is |m|*scale/q0, so a sunk scale
        # pushes the message below the EvalMod resolution while the
        # SlotToCoeff alpha fold amplifies the fit error by the same
        # factor.  Re-land at the canonical scale while a spare level
        # exists; callers keep one level above q0 at every refresh site
        # (models/bert.py does).  Without one the JAX package skips the
        # re-land silently; the port skips it too, with a warning.
        ratio = ct.scale / bt.ctx.scale
        if not (0.5 <= ratio <= 2.0):
            if ct.n_q >= bt.ctx.n_q0 + 2:
                ct = ev.match_scale(ct, bt.ctx.scale)
            else:
                warnings.warn(
                    f"refresh: scale {ct.scale:.6g} is {ratio:.3g}x the "
                    f"context's and no spare level is left to re-land it "
                    f"(n_q {ct.n_q})", RuntimeWarning, stacklevel=2)
        x = ev.mod_drop_to(ct, bt.ctx.n_q0)
        x = ev.with_scale(x, x.scale * m_bound,
                          reason="refresh: normalize |m| <= 1 for EvalMod")
        out = bt(x)
        out = ev.with_scale(out, out.scale / m_bound,
                            reason="refresh: undo m_bound normalization")
        if out.n_q > n_q:
            out = ev.mod_drop_to(out, n_q)
        return out

    return refresh
