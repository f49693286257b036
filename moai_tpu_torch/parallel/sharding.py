"""Device-mesh sharding of encrypted tensors on PyTorch devices.

Port of ``moai_tpu/parallel/sharding.py``.  The mesh's two axes are the
two kinds of parallelism of the scheme:

- ``col``, the ciphertext-column batch axis, is embarrassingly parallel:
  each device runs the unsharded code (``Evaluator``, ``Bootstrapper``,
  ``ops/matmul``) on its columns with its replica of the context and
  keys; the CCMM's sum over columns is a reduce of per-shard partial
  products (GSPMD's psum).
- ``limb``, the RNS-limb axis: dyadic ops, the Galois permutation and
  every NTT are limb-local; the key switch and the rescale need three
  collectives: the all-gather of the decomposed polynomial's coefficient
  form (every target limb reads every source limb), the all-gather of the
  accumulators' special limbs for the mod-down, and the broadcast of the
  limb a rescale drops.

In JAX the module only places arrays, and XLA's partitioner (GSPMD)
partitions the program and inserts the collectives.  PyTorch has no
partitioner that runs the port's own kernels, so this module also runs
the sharded programs (``ShardedEvaluator``, ``ShardedBootstrapper``,
``cpmm_sharded``, ``ccmm_col_to_diag_sharded``, ``softmax_diag_sharded``,
``ccmm_diag_to_col_sharded``: the attention head of
``__graft_entry__.dryrun_multichip``) and moves the data itself.  One process
drives the whole mesh, as JAX's single controller does: each op is issued
to every device before anything synchronises (eager launches on distinct
cards overlap), and the copies between devices are ``Tensor.to(device,
non_blocking=True)`` (peer copies on a multi-card host).  No process group
is involved.

Placement is GSPMD's.  For a mesh, an array shape and a spec, each
position's index ranges (``Sharding.devices_indices_map``,
``ShardedCiphertext.indices``) are JAX's ``NamedSharding.
devices_indices_map``, and a split axis must divide its dimension.
Positions that a spec replicates hold the same data and run the same
ops, as GSPMD's devices do.  Inside a program the limb count drops with
every rescale and the limb shards go ragged (JAX leaves those outputs
unconstrained too): each position keeps the limbs it held, the owner of
a dropped limb loses it, a shard may become empty, and ``gather`` puts
them back together exactly.

Keys.  They are replicated over ``col``.  Over ``limb`` each position
reads the key rows of the targets it computes: the Q limbs from the start
of its shard to the start of the next (every Q limb it can ever hold) and
its share of the K special limbs, an even split over the positions that
still hold Q limbs.  JAX's drivers split the key tensor's L + K rows
evenly instead; only outputs are compared, and they are bit-identical.
On the keys' own device a position reads its rows in place (``ks_mac``
takes a window of a key's rows), so a virtual mesh holds no copy of a
key.  A position on another device holds one copy of its Q rows and all K
special rows of each key it uses, cut at first use and kept, and no other
copy of the keys: its evaluator replica has the context alone.  The
sharded mod-down takes each position's inverse NTT of its own special
limbs before the all-gather (the residues of gathering first, with less
work).

Devices may repeat: a mesh of 8 x ``"cpu"`` or 4 x ``"cuda:0"`` is the
counterpart of the JAX tests' virtual CPU devices, time-sharing one real
device.  A replica (``Context.to`` and the others) on a device that already
holds the object is the object itself, so a virtual mesh on one card holds
one copy of the keys.

``moved`` counts the bytes handed from one mesh position to another (or
from and to the device of a sharded or gathered tensor), by kind; a
virtual mesh copies none of them, but counts what a real one would.
``copied`` counts, by the same kinds, the bytes of the tensors made for
them: all of them on a mesh of distinct cards, on a virtual mesh only a
placement's copies of strided slices (a limb shard of a tensor).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import mod_arith as ma
from ..boot.bootstrap import Bootstrapper
from ..ciphertext import Ciphertext, Plaintext
from ..evaluator import Evaluator, _require, _sum_leading
from ..keys import GaloisKeys
from ..ntt import intt
from ..params import resolve_device

AXES = ("col", "limb")

moved = {"scatter": 0, "gather": 0, "all_gather": 0, "broadcast": 0,
         "reduce": 0}
copied = dict(moved)


def reset_moved() -> None:
    for k in moved:
        moved[k] = copied[k] = 0


def _send(t: torch.Tensor, device: torch.device, kind: str) -> torch.Tensor:
    """t on ``device``, its bytes counted under ``kind`` in ``moved``, and
    in ``copied`` where a new tensor was made for it."""
    n = t.numel() * t.element_size()
    moved[kind] += n
    out = t.to(device, non_blocking=t.is_cuda and device.type == "cuda")
    if out is not t:
        copied[kind] += n
    return out


class Mesh:
    """A grid of torch devices [col, limb] with axes ("col", "limb")."""

    def __init__(self, devices):
        rows = [[torch.device(d) for d in r] for r in devices]
        _require(bool(rows) and bool(rows[0])
                 and all(len(r) == len(rows[0]) for r in rows),
                 "a mesh is a non-empty grid of devices")
        self.devices = rows
        self.shape = {"col": len(rows), "limb": len(rows[0])}

    def __getitem__(self, pos) -> torch.device:
        return self.devices[pos[0]][pos[1]]

    def positions(self) -> list:
        """Every (col, limb) position, in row-major order."""
        return [(i, j) for i in range(self.shape["col"])
                for j in range(self.shape["limb"])]

    def distinct(self) -> list:
        """The distinct devices, in order of first position."""
        return list(dict.fromkeys(self[p] for p in self.positions()))

    def __repr__(self) -> str:
        return f"Mesh({[[str(d) for d in r] for r in self.devices]})"


def make_mesh(n_devices: int | None = None, limb_axis: int = 1,
              devices=None) -> Mesh:
    """Mesh ("col", "limb") over the first ``n_devices`` devices (default
    all), reshaped to (n // limb_axis, limb_axis) in order.  Without
    ``devices``, the CUDA cards: raises when fewer are present than asked
    for, and never substitutes the CPU.  ``devices`` lists them explicitly
    and may repeat one (a virtual mesh)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; a mesh of CPU devices "
                               "is asked for with devices=['cpu', ...]")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(d) for d in devices]
        for d in devices:
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise RuntimeError(f"{d}: {torch.cuda.device_count()} CUDA "
                                   f"devices present")
    n = len(devices) if n_devices is None else n_devices
    if n > len(devices):
        raise RuntimeError(f"a mesh of {n} devices asked for, "
                           f"{len(devices)} present")
    if n < 1 or limb_axis < 1 or n % limb_axis:
        raise ValueError(f"{n} devices do not make rows of {limb_axis}")
    return Mesh([devices[r * limb_axis:(r + 1) * limb_axis]
                 for r in range(n // limb_axis)])


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which array axes are split over which mesh axis: ``spec`` holds one
    entry per leading array axis, "col", "limb" or None (not split); the
    axes past it are not split (JAX's PartitionSpec)."""
    mesh: Mesh
    spec: tuple

    def devices_indices_map(self, shape) -> dict:
        """{position: tuple of slices}, the index ranges each position
        holds: JAX's ``NamedSharding.devices_indices_map`` for the same
        mesh shape, spec and array shape, keyed by mesh position (a virtual
        mesh repeats devices).  Raises when a split axis does not divide
        its dimension."""
        shape = tuple(shape)
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        for d, (a, n) in enumerate(zip(spec, shape)):
            if a is not None and n % self.mesh.shape[a]:
                raise ValueError(
                    f"sharding {self.spec} on mesh {self.mesh.shape} splits "
                    f"array axis {d} {self.mesh.shape[a]} ways, but its size "
                    f"is {n} (full shape {shape}): the tiling factors should "
                    f"evenly divide the shape")
        out = {}
        for pos in self.mesh.positions():
            idx = []
            for a, n in zip(spec, shape):
                k = self.mesh.shape[a] if a is not None else 1
                if k == 1:
                    idx.append(slice(None))
                else:
                    r = pos[AXES.index(a)]
                    idx.append(slice(r * (n // k), (r + 1) * (n // k)))
            out[pos] = tuple(idx)
        return out


def ct_sharding(mesh: Mesh, batched: bool = True, limb: bool = False
                ) -> Sharding:
    """Sharding of ciphertext data [C, n_polys, L, N] (batched) or
    [n_polys, L, N]: C over ``col``, L over ``limb`` when ``limb``."""
    lmb = "limb" if limb else None
    return Sharding(mesh, ("col", None, lmb, None) if batched
                    else (None, lmb, None))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _split(n: int, k: int) -> list | None:
    """The even split of [0, n) in k ranges, which k must divide, or None
    when not split."""
    _require(n % k == 0, f"an axis of {n} does not split {k} ways")
    return None if k == 1 else [(r * (n // k), (r + 1) * (n // k))
                                for r in range(k)]


@dataclasses.dataclass
class ShardedCiphertext:
    """A ciphertext placed on a mesh: one ``Ciphertext`` per position, on
    that position's device.  ``cols``: each col index's range of the batch
    axis, None where the batch is not split (every row holds all of it);
    ``limbs``: each limb index's range of the limb axis (ragged inside a
    program, possibly empty), None where the limbs are not split.  Inside
    a sharded program a value may live on some rows only (a sum over col
    onto one row, one row's rotations): its shards are those rows'."""
    mesh: Mesh
    shards: dict
    cols: list | None
    limbs: list | None

    @property
    def _any(self) -> Ciphertext:
        return next(iter(self.shards.values()))

    @property
    def scale(self) -> float:
        return self._any.scale

    @property
    def is_ntt(self) -> bool:
        return self._any.is_ntt

    @property
    def n_polys(self) -> int:
        return self._any.n_polys

    @property
    def n_q(self) -> int:
        if self.limbs is None:
            return self._any.n_q
        return sum(hi - lo for lo, hi in self.limbs)

    def indices(self, pos) -> tuple:
        """The index ranges of the whole ciphertext that ``pos`` holds."""
        nd = self.shards[pos].data.dim()
        idx = [slice(None)] * nd
        if self.cols is not None:
            idx[0] = slice(*self.cols[pos[0]])
        if self.limbs is not None:
            idx[nd - 2] = slice(*self.limbs[pos[1]])
        return tuple(idx)


def shard_ciphertext(ct: Ciphertext, mesh: Mesh, limb: bool = False
                     ) -> ShardedCiphertext:
    """Place a Ciphertext on the mesh (a leading batch axis over ``col``;
    with ``limb``, the limbs over ``limb``), as ``ct_sharding`` says."""
    shape = tuple(ct.data.shape)
    batched = len(shape) > 3
    idx = ct_sharding(mesh, batched, limb).devices_indices_map(shape)
    shards = {pos: Ciphertext(_place(ct.data[idx[pos]], mesh[pos]),
                              ct.scale, ct.is_ntt)
              for pos in mesh.positions()}
    cols = _split(shape[0], mesh.shape["col"]) if batched else None
    limbs = _split(shape[-2], mesh.shape["limb"]) if limb else None
    return ShardedCiphertext(mesh, shards, cols, limbs)


def _place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A slice t of a tensor on ``device``, contiguous: sent as "scatter",
    its copy there counted in ``copied``."""
    out = _send(t, device, "scatter")
    if not out.is_contiguous():
        copied["scatter"] += out.numel() * out.element_size()
        out = out.contiguous()
    return out


def _limb_range(sct: ShardedCiphertext, pos) -> tuple:
    """The range of the limb axis sct's shard at pos holds."""
    return sct.limbs[pos[1]] if sct.limbs is not None else (0, sct.n_q)


def _rows(sct: ShardedCiphertext) -> list:
    """The col indices at which sct has shards."""
    return sorted({p[0] for p in sct.shards})


def gather(sct: ShardedCiphertext, device) -> Ciphertext:
    """The whole ciphertext back on ``device``, from the first position of
    each replicated axis."""
    device = resolve_device(device)
    rows = []
    for i in range(len(sct.cols)) if sct.cols is not None else [0]:
        js = range(len(sct.limbs)) if sct.limbs is not None else [0]
        parts = [_send(sct.shards[(i, j)].data, device, "gather")
                 for j in js]
        rows.append(torch.cat(parts, dim=-2) if len(parts) > 1 else parts[0])
    data = torch.cat(rows) if len(rows) > 1 else rows[0]
    return Ciphertext(data, sct.scale, sct.is_ntt)


class ShardedEvaluator:
    """The evaluator's ops over ShardedCiphertexts on ``mesh``.

    A ciphertext not split over ``limb`` runs each op at each position
    with that device's replica of ``ev`` (``Evaluator.to``): the unsharded
    code.  One split over ``limb`` runs the limb-local ops on each
    position's limb range and the key switch and rescale with their
    collectives (the module docstring), out of the evaluator's own pieces
    (``_dyadic``, ``_square``, ``_mul_int``, ``_const_residues_mont``,
    ``_ks_extend``, ``_targets``, ``_mod_down_q``, ``_rescale_top``,
    ``_rescale_rest``).  A plaintext operand is placed like the
    ciphertext (``_plain``).  The ops composed of others (``rotate``,
    ``rescale_pair``, ``match_scale`` and the rest below) are the
    evaluator's own code, run over these."""

    rotate = Evaluator.rotate
    conjugate = Evaluator.conjugate
    rescale_pair = Evaluator.rescale_pair
    multiply_relin = Evaluator.multiply_relin
    mul_relin_rescale = Evaluator.mul_relin_rescale
    square_rescale = Evaluator.square_rescale
    mul_const_to = Evaluator.mul_const_to
    match_scale = Evaluator.match_scale
    align = Evaluator.align
    level_pair_scale = Evaluator.level_pair_scale
    _naf_digits = Evaluator._naf_digits

    def __init__(self, ev: Evaluator, mesh: Mesh):
        self.base, self.mesh, self.ctx = ev, mesh, ev.ctx
        self.galois_keys = ev.galois_keys
        self._replicas = {ev.device: ev}
        self._bare = {}
        self._key_rows = {}

    def ev(self, pos) -> Evaluator:
        """The evaluator replica of position ``pos``, with all the keys
        (made at first use)."""
        d = self.mesh[pos]
        if d not in self._replicas:
            self._replicas[d] = self.base.to(d)
        return self._replicas[d]

    def _limb_ev(self, pos) -> Evaluator:
        """An evaluator on pos's device for the limb-sharded ops, which
        take their key rows from ``_rows_for``: the full replica where
        there is one, else one over the context's replica and the Galois
        permutations alone."""
        d = self.mesh[pos]
        if d in self._replicas:
            return self._replicas[d]
        if d not in self._bare:
            gks = self.base.galois_keys
            self._bare[d] = Evaluator(
                self.ctx.to(d), device=d,
                galois_keys=None if gks is None else GaloisKeys({}, gks.perms))
        return self._bare[d]

    # -- placement helpers -------------------------------------------------
    def _same(self, *scts) -> None:
        a = scts[0]
        for b in scts:
            _require(b.mesh is self.mesh and b.cols == a.cols
                     and b.limbs == a.limbs and b.shards.keys() ==
                     a.shards.keys(),
                     "operands are placed differently on the mesh")

    def _each(self, fn, *scts, limbs="same") -> ShardedCiphertext:
        """fn(pos, *shards) at each position holding a shard -> the placed
        result."""
        self._same(*scts)
        a = scts[0]
        shards = {pos: fn(pos, *[s.shards[pos] for s in scts])
                  for pos in a.shards}
        return ShardedCiphertext(self.mesh, shards, a.cols,
                                 a.limbs if limbs == "same" else limbs)

    def map_data(self, fn, *scts) -> ShardedCiphertext:
        """fn(*data) at each position (an op on the leading axes: a slice,
        a concatenation) -> the placed result, at the first's scale."""
        return self._each(lambda p, *xs: xs[0].with_data(
            fn(*[x.data for x in xs])), *scts)

    def _window(self, pos, lo: int, hi: int):
        """q and R^-1 [hi-lo, 1] of Q limbs [lo, hi) on pos's device."""
        dv = self._limb_ev(pos).dev
        return (dv["q"][lo:hi].reshape(-1, 1),
                dv["rinv"][lo:hi].reshape(-1, 1))

    def _qr(self, pos, a: ShardedCiphertext):
        """``_window`` of the limbs a's shard at pos holds."""
        return self._window(pos, *_limb_range(a, pos))

    def _gather_limbs(self, parts: dict, row: int, to: list) -> dict:
        """All-gather over the limb axis of row ``row``: the parts {j:
        tensor} concatenated in limb order on each position j of ``to``."""
        out = {}
        for r in to:
            dev = self.mesh[(row, r)]
            pieces = [parts[k] if k == r else
                      _send(parts[k], dev, "all_gather")
                      for k in sorted(parts)]
            out[r] = torch.cat(pieces, dim=-2) if len(pieces) > 1 \
                else pieces[0]
        return out

    def _rows_for(self, name, key, pos, s: int, e: int, plo: int, phi: int):
        """Key rows Q [s, e) + special [plo, phi) of ``key`` for pos, as
        ``ks_mac`` reads them: (a window of rows, the row its special
        share starts at).  On the key's own device the window is a view of
        the key; elsewhere it is a view of one copy of Q rows [s, e) and
        all K special rows, cut at first use and kept."""
        dev = self.mesh[pos]
        cur = key.q_limbs if key.q_limbs is not None else self.ctx.L
        _require(e <= cur, f"key holds {cur} Q limbs, a shard needs {e}")
        kd = key.data
        if kd.device == dev:
            return kd[..., s:cur + phi, :], cur + plo - s
        k = (name, dev, s, e)
        if k not in self._key_rows:
            self._key_rows[k] = torch.cat([kd[..., s:e, :], kd[..., cur:, :]],
                                          dim=-2).to(dev)
        return self._key_rows[k][..., :e - s + phi, :], e - s + plo

    # -- limb-local ops ----------------------------------------------------
    def add(self, a: ShardedCiphertext, b: ShardedCiphertext
            ) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x, y: self.ev(p).add(x, y), a, b)
        self.base._check_add("add", a, b)
        return self._each(lambda p, x, y: x.with_data(ma.add_mod(
            x.data, y.data, self._qr(p, a)[0])), a, b)

    def sub(self, a: ShardedCiphertext, b: ShardedCiphertext
            ) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x, y: self.ev(p).sub(x, y), a, b)
        self.base._check_add("sub", a, b)
        return self._each(lambda p, x, y: x.with_data(ma.sub_mod(
            x.data, y.data, self._qr(p, a)[0])), a, b)

    def multiply(self, a: ShardedCiphertext, b: ShardedCiphertext
                 ) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x, y: self.ev(p).multiply(x, y), a, b)
        _require(a.n_q == b.n_q and a.n_polys == 2 and b.n_polys == 2,
                 "multiply: two 2-poly ciphertexts at one level")
        return self._each(lambda p, x, y: Ciphertext(Evaluator._dyadic(
            x.data, y.data, *self._qr(p, a)),
            x.scale * y.scale, True), a, b)

    def square(self, a: ShardedCiphertext) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).square(x), a)
        return self._each(lambda p, x: Ciphertext(Evaluator._square(
            x.data, *self._qr(p, a)), x.scale * x.scale,
            True), a)

    def mul_int(self, a: ShardedCiphertext, n: int) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).mul_int(x, n), a)
        _require(n >= 1, "mul_int: n >= 1")
        return self._each(lambda p, x: x.with_data(Evaluator._mul_int(
            x.data, n, self._qr(p, a)[0])), a)

    def negate(self, a: ShardedCiphertext) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).negate(x), a)
        return self._each(lambda p, x: x.with_data(ma.neg_mod(
            x.data, self._qr(p, a)[0])), a)

    def _plain(self, pt: Plaintext, a: ShardedCiphertext, pos) -> Plaintext:
        """pt placed like a's shard at pos, on pos's device: a batch axis
        (the CPMM bias, the softmax masks) cut by a's cols, the residues cut
        to the shard's limb range."""
        d = pt.data
        if d.dim() > 2 and a.cols is not None:
            d = d[slice(*a.cols[pos[0]])]
        if a.limbs is not None:
            d = d[..., slice(*a.limbs[pos[1]]), :]
        return Plaintext(_send(d, self.mesh[pos], "scatter"), pt.scale,
                         pt.is_ntt)

    def add_plain(self, a: ShardedCiphertext, pt: Plaintext
                  ) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).add_plain(
                x, self._plain(pt, a, p)), a)
        self.base._check_add("add_plain", a, pt)
        return self._each(lambda p, x: Evaluator._with_c0(x, ma.add_mod(
            x.data[..., 0, :, :], self._plain(pt, a, p).data,
            self._qr(p, a)[0])), a)

    def multiply_plain(self, a: ShardedCiphertext, pt: Plaintext
                       ) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).multiply_plain(
                x, self._plain(pt, a, p)), a)
        _require(a.n_q == pt.n_q,
                 f"multiply_plain: levels {a.n_q} vs {pt.n_q}")
        return self._each(lambda p, x: Ciphertext(ma.mont_mul(
            x.data, self._plain(pt, a, p).data.unsqueeze(-3),
            *self._qr(p, a)), x.scale * pt.scale, x.is_ntt), a)

    def _const(self, p, a: ShardedCiphertext, value: float, scale: float):
        """``Evaluator._const_residues_mont`` of p's limbs."""
        lo, hi = a.limbs[p[1]]
        return self._limb_ev(p)._const_residues_mont(value, scale, hi, lo)

    def add_const(self, a: ShardedCiphertext, value: float
                  ) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).add_const(x, value), a)
        return self._each(lambda p, x: Evaluator._with_c0(x, ma.add_mod(
            x.data[..., 0, :, :], self._const(p, a, value, a.scale),
            self._qr(p, a)[0])), a)

    def mul_const(self, a: ShardedCiphertext, value: float,
                  const_scale: float | None = None) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).mul_const(
                x, value, const_scale), a)
        cs = const_scale if const_scale is not None else \
            self.level_pair_scale(a.n_q)
        return self._each(lambda p, x: Ciphertext(ma.mont_mul(
            x.data, self._const(p, a, value, cs),
            *self._qr(p, a)), x.scale * cs, x.is_ntt), a)

    # -- the leading (batch) axis ------------------------------------------
    def sum_leading(self, a: ShardedCiphertext) -> ShardedCiphertext:
        """``Evaluator.sum_leading``: each shard's sum over its part of the
        leading axis; where a's batch is split over col, those partials
        summed over col onto row 0 (GSPMD's psum, its result on one
        row)."""
        s = ShardedCiphertext(self.mesh, {p: x.with_data(_sum_leading(
            x.data, self._qr(p, a)[0])) for p, x in a.shards.items()}, None,
            a.limbs)
        return s if a.cols is None else _reduce_col(self, s)

    def expand_like(self, a: ShardedCiphertext, like: ShardedCiphertext
                    ) -> ShardedCiphertext:
        """``Evaluator.expand_like`` at each position of ``like``: a, one
        ciphertext held there (replicated over col), broadcast over like's
        shard of the leading axis (local)."""
        _require(a.limbs == like.limbs and a.cols is None,
                 "expand_like: one ciphertext placed like the batch's limbs")
        return ShardedCiphertext(self.mesh, {
            p: Evaluator.expand_like(a.shards[p], y)
            for p, y in like.shards.items()}, like.cols, like.limbs)

    def with_scale(self, a: ShardedCiphertext, scale: float, *,
                   reason: str) -> ShardedCiphertext:
        _require(bool(reason) and isinstance(reason, str),
                 "with_scale requires a justification string")
        return self._each(lambda p, x: Ciphertext(x.data, float(scale),
                                                  x.is_ntt), a)

    def mod_drop_to(self, a: ShardedCiphertext, n_q: int
                    ) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).mod_drop_to(x, n_q), a)
        _require(n_q <= a.n_q, f"mod_drop_to: {n_q} above {a.n_q}")
        limbs = [(lo, max(lo, min(hi, n_q))) for lo, hi in a.limbs]
        return self._each(lambda p, x: x.with_data(
            x.data[..., :limbs[p[1]][1] - limbs[p[1]][0], :]), a,
            limbs=limbs)

    # -- the key switch and the rescale over limb shards -------------------
    def _plan(self, a: ShardedCiphertext):
        """The limb indices that hold Q limbs, and each one's share of the
        K special limbs (an even split)."""
        K = self.ctx.K
        act = [j for j, (lo, hi) in enumerate(a.limbs) if hi > lo]
        return act, {j: (k * K // len(act), (k + 1) * K // len(act))
                     for k, j in enumerate(act)}

    def _decompose(self, a: ShardedCiphertext, polys: dict) -> dict:
        """The key switch's decomposition of limb-sharded polynomials {pos:
        [..., n, N]} (NTT form, a's limb ranges): each position's inverse
        NTT, all-gathered over its row, extended to the position's targets
        (its Q limbs and its special share) -> {pos: [..., D, T, N]}."""
        act, share = self._plan(a)
        y = {}
        for i in _rows(a):
            ev = {j: self._limb_ev((i, j)) for j in act}
            c = self._gather_limbs(
                {j: intt(polys[(i, j)], ev[j].tbd, limb_slice=a.limbs[j])
                 for j in act}, i, act)
            for j in act:
                y[(i, j)] = ev[j]._ks_extend(c.pop(j), a.n_q, *a.limbs[j],
                                             *share[j])
        return y

    def _mac_moddown(self, a: ShardedCiphertext, y: dict, keys: list,
                     perm: dict | None = None) -> dict:
        """y (``_decompose``) MAC'd at each position against its rows of
        ``keys`` ([(name, KSwitchKey)]: one key, or with perm {pos: [R,
        N]} one per rotation), then the mod-down by P: each position's
        special limbs to coefficients, all-gathered over its row, converted
        to its Q limbs -> {pos: (d0, d1)}."""
        L, m = self.ctx.L, self.mesh.shape["limb"]
        act, share = self._plan(a)
        first = keys[0][1]
        cur = first.q_limbs if first.q_limbs is not None else L
        ends = [a.limbs[j + 1][0] for j in range(m - 1)] + [cur]
        out = {}
        for i in _rows(a):
            ev = {j: self._limb_ev((i, j)) for j in act}
            acc = {}
            for j in act:
                p, (lo, hi) = (i, j), a.limbs[j]
                rows = [self._rows_for(name, key, p, lo, ends[j], *share[j])
                        for name, key in keys]
                acc[j] = ma.ks_mac(
                    y[p], rows[0][0] if perm is None else [r for r, _ in rows],
                    rows[0][1], *ev[j]._targets(lo, hi, *share[j]),
                    None if perm is None else perm[p])
            res = []
            for h in (0, 1):
                cp = {}
                for j in act:
                    nq = a.limbs[j][1] - a.limbs[j][0]
                    plo, phi = share[j]
                    if phi > plo:
                        cp[j] = intt(acc[j][h][..., nq:, :], ev[j].tbd,
                                     limb_slice=(L + plo, L + phi))
                cp = self._gather_limbs(cp, i, act)
                res.append({j: ev[j]._mod_down_q(
                    acc[j][h][..., :a.limbs[j][1] - a.limbs[j][0], :],
                    cp[j], *a.limbs[j]) for j in act})
            for j in act:
                out[(i, j)] = (res[0][j], res[1][j])
        return out

    def _switch_key(self, a: ShardedCiphertext, polys: dict, name, key):
        """Hybrid key switch of limb-sharded polynomials -> {pos: (ks0,
        ks1)} at the positions that hold Q limbs."""
        return self._mac_moddown(a, self._decompose(a, polys), [(name, key)])

    def relinearize(self, a: ShardedCiphertext) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).relinearize(x), a)
        _require(a.n_polys == 3 and self.base.relin_key is not None,
                 "relinearize: a 3-poly ciphertext and a relin key")
        ks = self._switch_key(a, {p: x.data[..., 2, :, :]
                                  for p, x in a.shards.items()},
                              "relin", self.base.relin_key)

        def f(p, x):
            if p not in ks:
                return x.with_data(x.data[..., :2, :, :])
            q = self._qr(p, a)[0]
            return x.with_data(torch.stack(
                [ma.add_mod(x.data[..., h, :, :], ks[p][h], q)
                 for h in (0, 1)], dim=-3))
        return self._each(f, a)

    def apply_galois(self, a: ShardedCiphertext, g: int
                     ) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).apply_galois(x, g), a)
        _require(a.n_polys == 2, "apply_galois: a 2-poly ciphertext")
        d = {p: torch.index_select(x.data, -1, self._limb_ev(p)._perm(g))
             for p, x in a.shards.items()}
        ks = self._switch_key(a, {p: t[..., 1, :, :] for p, t in d.items()},
                              g, self.base.galois_keys.keys[g])

        def f(p, x):
            if p not in ks:
                return x.with_data(d[p])
            q = self._qr(p, a)[0]
            return x.with_data(torch.stack(
                [ma.add_mod(d[p][..., 0, :, :], ks[p][0], q), ks[p][1]],
                dim=-3))
        return self._each(f, a)

    def rotate_hoisted(self, a: ShardedCiphertext, steps: list,
                       chunk: int | None = None) -> ShardedCiphertext:
        """``Evaluator.rotate_hoisted``: one decomposition, all-gathered
        once, then ``chunk`` rotations per MAC (each position reading its
        rows of each rotation's key through the rotation's permutation)
        and mod-down -> a new leading axis R = len(steps)."""
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).rotate_hoisted(
                x, steps, chunk), a)
        _require(a.n_polys == 2, "rotate_hoisted: a 2-poly ciphertext")
        two_n, n = 2 * self.ctx.cfg.N, self.ctx.cfg.N // 2
        elts = [pow(5, s % n, two_n) for s in steps]
        y = self._decompose(a, {p: x.data[..., 1, :, :]
                                for p, x in a.shards.items()})
        chunk = chunk or len(steps)
        outs = []
        for s0 in range(0, len(steps), chunk):
            es = elts[s0:s0 + chunk]
            perm = {p: torch.stack([self._limb_ev(p)._perm(g) for g in es])
                    for p in a.shards}
            d = self._mac_moddown(
                a, y, [(g, self.base.galois_keys.keys[g]) for g in es], perm)

            def f(p, x):
                c0 = x.data[..., 0, :, :][..., perm[p]].movedim(-2, 0)
                if p not in d:
                    return x.with_data(torch.stack([c0, c0], dim=-3))
                q = self._qr(p, a)[0]
                return x.with_data(torch.stack(
                    [ma.add_mod(c0, d[p][0], q), d[p][1]], dim=-3))
            outs.append(self._each(f, a))
        return outs[0] if len(outs) == 1 else \
            self.map_data(lambda *ds: torch.cat(ds), *outs)

    def rescale(self, a: ShardedCiphertext) -> ShardedCiphertext:
        if a.limbs is None:
            return self._each(lambda p, x: self.ev(p).rescale(x), a)
        ell = a.n_q - 1
        _require(ell >= 1, "rescale: no prime left to drop")
        o = next(j for j, (lo, hi) in enumerate(a.limbs) if lo <= ell < hi)
        limbs = [(lo, max(lo, min(hi, ell))) for lo, hi in a.limbs]
        scale = a.scale / self.ctx.q_primes[ell]
        top = a.limbs[o][0]
        u = {i: self._limb_ev((i, o))._rescale_top(
            a.shards[(i, o)].data[..., ell - top:ell - top + 1, :], ell)
            for i in _rows(a)}

        def f(p, x):
            lo, hi = limbs[p[1]]
            data = x.data[..., :hi - lo, :]
            if hi > lo:
                up = u[p[0]] if p[1] == o else \
                    _send(u[p[0]], self.mesh[p], "broadcast")
                data = self._limb_ev(p)._rescale_rest(data, up, ell, lo,
                                                      hi)
            return Ciphertext(data, scale, True)
        return self._each(f, a, limbs=limbs)


class ShardedBootstrapper:
    """A Bootstrapper over a mesh.  A batch split over ``col`` alone
    bootstraps each position's columns with its device's replica
    (``Bootstrapper.to``): the unsharded code.  A ciphertext split over
    ``limb`` runs ``Bootstrapper.__call__`` itself over the
    ``ShardedEvaluator`` (EvalMod is evaluator ops only), with ModRaise,
    the CoeffToSlot/SlotToCoeff levels and the multiplication by i on each
    position's limb range out of the Bootstrapper's own pieces: ModRaise
    all-gathers its n_q0 lifted limbs and each position converts them to
    its even share of the L limbs; each level's diagonals are encoded per
    replica and turned into residues of the position's limbs only."""

    _run = Bootstrapper.__call__
    _stage = Bootstrapper._stage

    def __init__(self, bt: Bootstrapper, mesh: Mesh):
        self.bt, self.mesh = bt, mesh
        self.ev = ShardedEvaluator(bt.ev, mesh)
        self.ctx, self.encoder, self.mr = bt.ctx, bt.encoder, bt.mr
        self.c2s_levels, self.s2c_levels = bt.c2s_levels, bt.s2c_levels
        self.q0, self.n_out = bt.q0, bt.n_out
        self.on_stage = None
        self._full, self._bare = {}, {}

    def bootstrapper(self, pos) -> Bootstrapper:
        """The replica of position ``pos``, with all the keys."""
        d = self.mesh[pos]
        if d not in self._full:
            self._full[d] = self.bt.to(d, self.ev.ev(pos))
        return self._full[d]

    def _limb_bt(self, pos) -> Bootstrapper:
        """The replica for the limb-sharded pieces, over the evaluator of
        ``ShardedEvaluator._limb_ev``."""
        d = self.mesh[pos]
        if d not in self._bare:
            self._bare[d] = self.bt.to(d, self.ev._limb_ev(pos))
        return self._bare[d]

    def __call__(self, sct: ShardedCiphertext) -> ShardedCiphertext:
        """The bootstrap of a sharded ciphertext (the boot program of
        tools/multichip_dryrun.py)."""
        if sct.limbs is None:
            return ShardedCiphertext(
                self.mesh, {p: self.bootstrapper(p)(x)
                            for p, x in sct.shards.items()}, sct.cols, None)
        return self._run(sct)

    def modraise(self, a: ShardedCiphertext) -> ShardedCiphertext:
        sev, n0, L = self.ev, self.ctx.n_q0, self.ctx.L
        _require(a.n_q == n0, f"modraise: input at {a.n_q} limbs, not {n0}")
        m = self.mesh.shape["limb"]
        _require(L % m == 0, f"{L} limbs do not split {m} ways")
        limbs = [(j * L // m, (j + 1) * L // m) for j in range(m)]
        act = [j for j, (lo, hi) in enumerate(a.limbs) if hi > lo]
        shards = {}
        for i in _rows(a):
            lam = sev._gather_limbs(
                {j: self._limb_bt((i, j))._modraise_lift(
                    a.shards[(i, j)].data, *a.limbs[j]) for j in act},
                i, list(range(m)))
            for j in range(m):
                shards[(i, j)] = Ciphertext(self._limb_bt(
                    (i, j))._modraise_convert(lam[j], *limbs[j]), a.scale,
                    True)
        return ShardedCiphertext(self.mesh, shards, a.cols, limbs)

    def mul_i(self, a: ShardedCiphertext) -> ShardedCiphertext:
        def f(p, x):
            lo, hi = a.limbs[p[1]]
            return x.with_data(ma.mont_mul(
                x.data, self._limb_bt(p)._i_mono(hi)[lo:],
                *self.ev._window(p, lo, hi)))
        return self.ev._each(f, a)

    def _linear(self, kind: str, i: int, a: ShardedCiphertext,
                alpha: float | None = None) -> ShardedCiphertext:
        """``boot.linear.apply_diagonals`` of level i over limb shards: the
        hoisted baby rotations, one diag_mac per giant step on each
        position's limbs, the giant rotations, one rescale pair."""
        from ..boot.linear import _giant_groups, diagonal_plaintexts
        sev = self.ev
        lev = (self.c2s_levels if kind == "c2s" else self.s2c_levels)[i]
        g, groups = _giant_groups(lev)
        scale = sev.level_pair_scale(a.n_q)
        enc = {p: self._limb_bt(p)._encoded(kind, i, a.n_q, alpha)
               for p in a.shards}
        rot = {0: a}
        nonzero = [s for s in sorted({d % g for d in lev}) if s]
        if nonzero:
            hoisted = sev.rotate_hoisted(a, nonzero)
            for k, s in enumerate(nonzero):
                rot[s] = sev.map_data(lambda d, k=k: d[k], hoisted)
            del hoisted
        total = None
        for gi, ds in sorted(groups.items()):
            def f(p, *xs):
                lo, hi = a.limbs[p[1]]
                data = xs[0].data
                if hi > lo:
                    pts = diagonal_plaintexts(
                        self._limb_bt(p).ctx, [enc[p][(gi, d)] for d in ds],
                        hi, lo)
                    data = ma.diag_mac([x.data for x in xs], pts,
                                       *sev._window(p, lo, hi))
                return Ciphertext(data, a.scale * scale, True)
            part = sev._each(f, *[rot[d % g] for d in ds])
            if gi:
                part = sev.rotate(part, gi)
            total = part if total is None else sev.add(total, part)
        del rot
        return sev.rescale_pair(total)

    def make_refresh(self, m_bound: float = 1.0):
        """``boot.bootstrap.make_refresh`` over the mesh: refresh(ct, n_q)
        shards ct over ``col`` (and over ``limb`` when the mesh's limb axis
        is more than 1), runs the refresh on the shards and gathers the
        result back onto ct's device."""
        from ..boot.bootstrap import make_refresh
        inner = make_refresh(self, m_bound)
        limb = self.mesh.shape["limb"] > 1

        def refresh(ct: Ciphertext, n_q: int) -> Ciphertext:
            out = inner(shard_ciphertext(ct, self.mesh, limb=limb), n_q)
            return gather(out, ct.data.device)
        return refresh


def _row(sct: ShardedCiphertext, i: int) -> ShardedCiphertext:
    """Row i of sct alone: its shards there (one row splits no batch)."""
    return ShardedCiphertext(sct.mesh, {p: x for p, x in sct.shards.items()
                                        if p[0] == i}, None, sct.limbs)


def _reduce_col(sev: ShardedEvaluator, a: ShardedCiphertext, to: int = 0,
                scatter: bool = False) -> ShardedCiphertext:
    """a's shards, one partial of a contraction per row that holds them,
    summed over col with ``add_mod`` in mesh order: onto row ``to``
    (GSPMD's psum, its result on one row), or with ``scatter`` each row
    receiving the sum of its even range of the batch (GSPMD's
    reduce-scatter: the psum of a contraction whose output is split over
    col)."""
    mesh = sev.mesh
    if scatter:
        cols = _split(a._any.data.shape[0], mesh.shape["col"])
        if cols is None:
            return a
        targets = dict(enumerate(cols))
    else:
        cols, targets = None, {to: (None, None)}
    shards = {}
    for r, (lo, hi) in targets.items():
        for j in range(mesh.shape["limb"]):
            t = None
            for i in _rows(a):
                d = a.shards[(i, j)].data[lo:hi]
                if i != r:
                    d = _send(d, mesh[(r, j)], "reduce")
                t = d if t is None else ma.add_mod(t, d,
                                                   sev._qr((r, j), a)[0])
            shards[(r, j)] = Ciphertext(t, a.scale, a.is_ntt)
    return ShardedCiphertext(mesh, shards, cols, a.limbs)


def _replicate(sev: ShardedEvaluator, a: ShardedCiphertext
               ) -> ShardedCiphertext:
    """a, held on one row, on every row (a broadcast over col)."""
    (src,) = _rows(a)
    return ShardedCiphertext(sev.mesh, {
        (i, j): a.shards[(src, j)] if i == src else a.shards[(src, j)]
        .with_data(_send(a.shards[(src, j)].data, sev.mesh[(i, j)],
                         "broadcast")) for i, j in sev.mesh.positions()},
        None, a.limbs)


def _gather_cols(sev: ShardedEvaluator, a: ShardedCiphertext
                 ) -> ShardedCiphertext:
    """a's batch, split over col, whole on every row (an all-gather over
    col)."""
    if a.cols is None:
        return a
    mesh = sev.mesh
    return ShardedCiphertext(mesh, {(r, j): a.shards[(r, j)].with_data(
        torch.cat([a.shards[(i, j)].data if i == r else _send(
            a.shards[(i, j)].data, mesh[(r, j)], "all_gather")
            for i in range(mesh.shape["col"])]))
        for r, j in mesh.positions()}, None, a.limbs)


def _split_cols(sev: ShardedEvaluator, a: ShardedCiphertext
                ) -> ShardedCiphertext:
    """a's batch, whole on every row, split over col: each row keeps its
    even range (a local slice, nothing moved)."""
    if a.cols is not None:
        return a
    cols = _split(a._any.data.shape[0], sev.mesh.shape["col"])
    if cols is None:
        return a
    return ShardedCiphertext(sev.mesh, {
        p: x.with_data(x.data[slice(*cols[p[0]])])
        for p, x in a.shards.items()}, cols, a.limbs)


def cpmm_sharded(sev: ShardedEvaluator, mm, x: ShardedCiphertext
                 ) -> ShardedCiphertext:
    """``ops.matmul.CPMM.__call__`` over the mesh: x's batch (the rows J of
    W) split over col, its limbs over limb or not.  Each position takes
    ``CPMM.product`` over its rows of W and its limb window; the partials
    are summed over col, each row receiving its even range of the output
    columns I (GSPMD's reduce-scatter: the psum of the contraction over
    the split col axis, into the output's col split); then ``CPMM.
    finish_ct`` on each shard: the mask, the two rescales with their limb
    broadcast and the bias land after the sum (a rescale of a sum is not
    the sum of rescales).  The sums are exact: the residues are the
    unsharded ones."""
    _require(x.n_q == mm.n_q, f"CPMM built for n_q={mm.n_q}, got {x.n_q}")
    _require(x.cols is not None or sev.mesh.shape["col"] == 1,
             "cpmm_sharded: x's batch is to be split over col")
    out = _reduce_col(sev, ShardedCiphertext(sev.mesh, {p: Ciphertext(
        mm.product(xs, rows=None if x.cols is None else slice(*x.cols[p[0]]),
                   window=_limb_range(x, p)), x.scale * mm.w_scale, True)
        for p, xs in x.shards.items()}, None, x.limbs), scatter=True)
    return mm.finish_ct(sev, out)


def softmax_diag_sharded(sev: ShardedEvaluator, encoder,
                         x: ShardedCiphertext, masks, max_val: float,
                         refresh, inv_iters: int = 16, eps: float = 1e-5,
                         out_n_q: int | None = None, exp_r: int = 7
                         ) -> ShardedCiphertext:
    """``ops.nonlinear.softmax_diag`` over the mesh: ``softmax_exp_sum``
    and ``softmax_finish`` run over ``sev``.  x's diagonals are split over
    col (a replicated x, as ``ccmm_col_to_diag_sharded`` returns it, is
    sliced locally); the masks' plaintexts are placed like them.  The
    shift, the exp and the mask run per shard; the sum over the diagonals
    (``ShardedEvaluator.sum_leading``) is each shard's partial, summed over
    col onto row 0 (GSPMD's psum), where it takes ``eps`` and ``refresh``
    (ShardedCiphertext -> ShardedCiphertext, called once); the sum is then
    broadcast over col and every row takes its Goldschmidt inverse
    (replicated over col, as GSPMD places it, its limbs split where x's
    are), and multiplies it into its own diagonals."""
    from ..ops.nonlinear import softmax_exp_sum, softmax_finish
    e, s = softmax_exp_sum(sev, encoder, _split_cols(sev, x), masks, max_val,
                           eps=eps, exp_r=exp_r)
    return softmax_finish(sev, e, _replicate(sev, refresh(s)),
                          inv_iters=inv_iters, out_n_q=out_n_q)


def ccmm_diag_to_col_sharded(sev: ShardedEvaluator, x: ShardedCiphertext,
                             v: ShardedCiphertext, num_x: int, num_row: int
                             ) -> ShardedCiphertext:
    """``ops.matmul.ccmm_diag_to_col`` over the mesh: the diagonals of A
    split over col (a replicated A is sliced locally), V whole on every
    row (a col-split V is all-gathered).  Each row rotates V by the baby
    steps its own diagonals use (hoisted) and forms, for every BSGS group
    its diagonals meet, the group's 3-poly partial product over them,
    pre-rotated by the group's global -g*bi*num_x.  A group cut between
    rows has its partials summed over col onto the first row holding it
    (relinearization is not linear in the residues: the partials meet
    before it); that row relinearizes the group and giant-rotates it.  The
    rows' sums are summed over col, each row receiving its even range of
    V's columns (GSPMD's reduce-scatter, into the output's P("col", None,
    "limb", None)), and every shard takes the two rescales.  The residues
    are the unsharded ones."""
    from ..ops.matmul import DIAG_ROT_CHUNK, _bsgs_split, _dyadic_sum
    m, mesh = num_row, sev.mesh
    x, v = _split_cols(sev, x), _gather_cols(sev, v)
    spans = x.cols or [(0, x._any.data.shape[0])]
    _require(spans[-1][1] == m, f"{spans[-1][1]} diagonals for num_row={m}")
    if x.n_q != v.n_q:
        raise ValueError(f"ccmm_diag_to_col level mismatch: A at n_q={x.n_q}"
                         f", V at n_q={v.n_q}")
    g, _ = _bsgs_split(m)
    prod_scale = x.scale * v.scale
    parts, totals = {}, {}            # group -> {row: partial}; row -> sum

    def close(bi, held):
        """Relinearize and giant-rotate group bi on the first row holding
        it, its partials summed there, into that row's sum."""
        own = min(held)
        grp = held[own] if len(held) == 1 else _reduce_col(
            sev, ShardedCiphertext(mesh, {p: y for c in held.values()
                                          for p, y in c.shards.items()},
                                   None, x.limbs), to=own)
        part = sev.relinearize(grp)
        if bi:
            part = sev.rotate(part, g * bi * num_x)       # giant step
        totals[own] = part if own not in totals else \
            sev.add(totals[own], part)

    for i, (lo, hi) in enumerate(spans):
        xi, vi = _row(x, i), _row(v, i)
        steps = sorted({d % g for d in range(lo, hi)} - {0})
        vr = {0: vi}
        if steps:
            hv = sev.rotate_hoisted(vi, [s * num_x for s in steps],
                                    chunk=DIAG_ROT_CHUNK)
            for k, s in enumerate(steps):
                vr[s] = sev.map_data(lambda d, k=k: d[k], hv)
            del hv
        for bi in range(lo // g, -(-hi // g)):
            glo, ghi = max(lo, bi * g), min(hi, (bi + 1) * g)
            grp = sev.map_data(lambda d: d[glo - lo:ghi - lo], xi)
            if bi:                    # the pre-rotation of global group bi
                grp = sev.rotate(grp, -g * bi * num_x)

            def f(p, gx, *vs):
                vb = torch.stack([y.data for y in vs])
                return Ciphertext(_dyadic_sum(
                    gx.data[:, None, 0], gx.data[:, None, 1], vb[:, :, 0],
                    vb[:, :, 1], 0, *sev._qr(p, xi)), prod_scale, True)
            parts.setdefault(bi, {})[i] = sev._each(
                f, grp, *[vr[s] for s in range(glo - bi * g, ghi - bi * g)])
        for bi in [bi for bi in parts if min((bi + 1) * g, m) <= hi]:
            close(bi, parts.pop(bi))
    out = _reduce_col(sev, ShardedCiphertext(mesh, {
        p: y for t in totals.values() for p, y in t.shards.items()}, None,
        x.limbs), scatter=True)
    return sev.rescale(sev.rescale(out))


def ccmm_col_to_diag_sharded(sev: ShardedEvaluator, x: ShardedCiphertext,
                             w: ShardedCiphertext, num_x: int, num_row: int,
                             col_chunk: int | None = None
                             ) -> ShardedCiphertext:
    """``ops.matmul.ccmm_col_to_diag`` over X and W sharded on col, on limb
    or on both: each position's partial products over its columns,
    ``col_chunk`` at a time (the double BSGS's hoisted rotations and
    ``ccmm_col_products``, each position's folded into its partial before
    the next position's is made), summed over the col axis onto row 0
    with ``add_mod`` in mesh order (GSPMD's psum), finished there
    (relinearization, the giant output rotations, the rescale, as
    ``ccmm_col_to_diag_finish``) and replicated to every row.  Mesh rows
    that share a device (a virtual mesh's) hold their rotated operands at
    once, so each takes ``col_chunk`` over their number: the device holds
    the unsharded run's.  The sums are exact, so the residues are the
    unsharded ones."""
    from ..ops.matmul import (CCMM_ROT_CHUNK, _bsgs_split,
                              ccmm_col_products, ccmm_col_rotations)
    sev._same(x, w)
    mesh = sev.mesh
    baby, giant = ccmm_col_rotations(num_x, num_row)
    C = x._any.data.shape[0]
    share = max(sum(d in row for row in mesh.devices)
                for d in mesh.distinct())
    chunk = max(1, col_chunk // share) if col_chunk else C
    acc = {}                      # position -> its partial [b, g, 3, n, N]
    for lo in range(0, C, chunk):
        xc, wc = [sev.map_data(lambda d: d[lo:lo + chunk], c) for c in (x, w)]
        wr = sev.rotate_hoisted(wc, baby, CCMM_ROT_CHUNK) if baby else None
        xr = sev.rotate_hoisted(xc, giant, CCMM_ROT_CHUNK) if giant else None
        for p, xs in xc.shards.items():
            wb, xg = wc.shards[p].data[None], xs.data[None]
            if wr is not None:
                wb = torch.cat([wb, wr.shards[p].data])
            if xr is not None:
                xg = torch.cat([xg, xr.shards[p].data])
            q, rinv = sev._qr(p, xc)
            part = ccmm_col_products(xg, wb, q, rinv)
            del wb, xg
            acc[p] = part if p not in acc else ma.add_mod(acc[p], part, q)
            del part
        del wr, xr
    acc = ShardedCiphertext(mesh, {p: Ciphertext(t, x.scale * w.scale, True)
                                   for p, t in acc.items()}, x.cols, x.limbs)
    # the sum over the col axis (over distinct column shards only), onto
    # row 0
    total = _reduce_col(sev, acc if x.cols is not None else _row(acc, 0))
    del acc
    g, b = _bsgs_split(num_row)
    rel = sev.relinearize(total)
    del total
    diags = []
    for bi in range(b):
        ng = min(g, num_row - bi * g)
        grp = sev.map_data(lambda d: d[bi, :ng], rel)
        diags.append(sev.rotate(grp, g * bi * num_x) if bi else grp)
    out = sev.rescale(sev.rescale(sev.map_data(
        lambda *ds: torch.cat(ds), *diags)))
    return _replicate(sev, out)
