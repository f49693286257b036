"""moai_tpu_torch.utils.debug and the evaluator's ``debug`` hook against
moai_tpu's, at logN 9 (the chain of tests/test_serial.py).

The JAX package fires its hook while tracing, so its trace of the seven
hooked ops comes from ``jax.eval_shape`` (no compile); the port fires as
each op returns, on the JAX package's ciphertext carried over with
``convert``.  Both give the same (op, n_q, scale) events and printouts, and
attaching the hook changes no residue."""

import re

import jax
import numpy as np
import pytest
import torch

from moai_tpu.ciphertext import Ciphertext as JCiphertext, \
    Plaintext as JPlaintext
from moai_tpu.encoder import Encoder as JEncoder
from moai_tpu.encrypt import Encryptor as JEncryptor, Decryptor as JDecryptor
from moai_tpu.evaluator import Evaluator as JEvaluator
from moai_tpu.keys import KeyGenerator as JKeyGenerator
from moai_tpu.params import CKKSConfig as JCKKSConfig, make_context
from moai_tpu.utils import debug as jdebug
from moai_tpu_torch import convert
from moai_tpu_torch.ciphertext import Plaintext
from moai_tpu_torch.encoder import Encoder
from moai_tpu_torch.encrypt import Decryptor
from moai_tpu_torch.evaluator import Evaluator
from moai_tpu_torch.params import CKKSConfig, Context
from moai_tpu_torch.utils import debug

torch.set_num_threads(1)
CFG = dict(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
           n_data_levels=4, n_boot_levels=0, dnum=2, hamming_weight=32)
STEPS = [1, 2]


@pytest.fixture(scope="module")
def jax_keys():
    """One set of JAX keys, a ciphertext of two slot vectors and a
    plaintext at its level, for the whole file."""
    ctx = make_context(JCKKSConfig(**CFG))
    enc = JEncoder(ctx)
    kg = JKeyGenerator(ctx, seed=9)
    gks = kg.gen_galois_keys(steps=STEPS)
    encryptor = JEncryptor(ctx, enc, kg.gen_public_key(), kg)
    ev = JEvaluator(ctx, relin_key=kg.gen_relin_key(), galois_keys=gks)
    vals = np.random.default_rng(1).uniform(-1, 1, (2, ctx.cfg.slots))
    ct = encryptor.encrypt(encryptor.encode(vals))
    pt = encryptor.encode(vals[0], n_q=ct.n_q)
    return dict(ctx=ctx, enc=enc, kg=kg, ev=ev, vals=vals, ct=ct, pt=pt)


@pytest.fixture(scope="module")
def port(jax_keys):
    j = jax_keys
    ctx = Context(CKKSConfig(**CFG), device="cpu")
    ev = Evaluator(ctx, relin_key=convert.kswitch_key(j["ev"].relin_key,
                                                      device="cpu"),
                   galois_keys=convert.galois_keys(j["ev"].galois_keys,
                                                   device="cpu"),
                   device="cpu")
    return dict(ctx=ctx, ev=ev, ct=convert.ciphertext(j["ct"], device="cpu"),
                pt=convert.plaintext(j["pt"], device="cpu"))


def _seven_ops(ev, c, p, plaintext):
    """multiply, relinearize, rescale, rotate, hoisted rotate,
    multiply_plain, mod_drop_to: one call each."""
    s = ev.rescale(ev.relinearize(ev.multiply(c, c)))
    return [s, ev.rotate(s, 1), ev.rotate_hoisted(s, STEPS),
            ev.multiply_plain(c, plaintext(p.data, p.scale, True)),
            ev.mod_drop_to(c, 4)]


def test_op_trace_matches_jax(jax_keys, port, capsys):
    j, t = jax_keys, port
    jtrace = jdebug.OpTrace(with_print=True)
    j["ev"].debug = jtrace
    try:
        jax.eval_shape(lambda d, p: [r.data for r in _seven_ops(
            j["ev"], JCiphertext(d, j["ct"].scale, True),
            JPlaintext(p, j["pt"].scale, True), JPlaintext)],
            j["ct"].data, j["pt"].data)
    finally:
        j["ev"].debug = None
    jax_lines = capsys.readouterr().out

    ev = t["ev"]
    assert ev.debug is None
    plain = _seven_ops(ev, t["ct"], t["pt"], Plaintext)
    trace = debug.OpTrace(with_print=True)
    ev.debug = trace
    try:
        hooked = _seven_ops(ev, t["ct"], t["pt"], Plaintext)
    finally:
        ev.debug = None
    assert capsys.readouterr().out == jax_lines
    assert trace.events == jtrace.events
    assert [e[0] for e in trace.events] == [
        "multiply", "relinearize", "rescale", "apply_galois",
        "rotate_hoisted", "multiply_plain", "mod_drop_to"]
    assert trace.summary() == jtrace.summary()
    assert trace.min_n_q() == jtrace.min_n_q() == 4
    for a, b in zip(plain, hooked):
        assert a.scale == b.scale and torch.equal(a.data, b.data)


def test_noise_probe_matches_jax(jax_keys, port):
    j, t = jax_keys, port
    jprobe = jdebug.NoiseProbe(
        JDecryptor(j["ctx"], j["enc"], j["kg"].sk), verbose=False)
    probe = debug.NoiseProbe(
        Decryptor(t["ctx"], Encoder(t["ctx"]),
                  convert.secret_key(j["kg"].sk, device="cpu"),
                  device="cpu"), verbose=False)
    for expected in (j["vals"], None):
        want = jprobe("x", j["ct"], expected)
        got = probe("x", t["ct"], expected)
        assert got == want            # the same decryption, decode, max
        assert got < 1e-6
    assert [n for n, _ in probe.probes] == ["x", "x"]


def test_stage_timer_accumulates(capsys):
    timers = (debug.StageTimer(), jdebug.StageTimer())
    for timer in timers:
        for name in ("encode", "layer", "encode", None):
            with timer(name):
                if timer is timers[0]:
                    timer.block(torch.zeros(3))     # on the CPU: no wait
    lines = capsys.readouterr().out.splitlines()
    shape = re.compile(r"\[moai\] (encode|layer|stage2) +\d+\.\d{3} s$")
    assert len(lines) == 8 and all(shape.match(x) for x in lines)
    t, jt = timers
    assert list(t.stages) == list(jt.stages) == ["encode", "layer", "stage2"]
    assert t.total() == pytest.approx(sum(t.stages.values()))
    assert set(t.as_dict()) == set(t.stages)
