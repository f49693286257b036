"""The bootstrap's plain reference and its judge.

A bootstrap refreshes a ciphertext and leaves its message as it was: the
reference of a refreshed batch is the slot values the benchmark drew and
encrypted, every slot of every ciphertext, real and imaginary parts (the
imaginary parts are 0).  The refreshed ciphertext has to lie on the data
chain the configuration states (``out_limbs`` limbs), and every limb has
to hold the same message: a limb that ModRaise, CoeffToSlot, EvalMod or
SlotToCoeff left wrong shows as a residue that disagrees with the bottom
two.  ``slot_values`` takes a ``dtype``: in the configuration's
``control_dtype`` it is the control that has to fail a limit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ckks

FAIL = 1e30        # a number compared on an output of the wrong shape


def values(seed: int, batch: int, slots: int, bound: float) -> np.ndarray:
    """U(-bound, bound) slot values [batch, slots], one vector per
    ciphertext, from a stream of the seed that the program does not draw
    from."""
    return np.random.default_rng([seed, 2]).uniform(-bound, bound,
                                                    (batch, slots))


def slot_values(vals: np.ndarray, dtype=torch.float64, device="cpu"
                ) -> torch.Tensor:
    return torch.as_tensor(vals, device=device).to(dtype).to(torch.float64)


def pack(want: torch.Tensor, spec: dict) -> torch.Tensor:
    """Reference values [batch, slots] -> the slots of the output
    ciphertexts, [batch, N/2]: the same."""
    return want


def judge(data: torch.Tensor, scale: float, spec: dict, want: torch.Tensor
          ) -> dict:
    """The numbers compared for one refreshed batch (residues ``data`` at
    ``scale``) against ``want`` [batch, slots]: max_abs_err and rms_err
    (the largest and the root-mean-square complex modulus of decoded -
    want), limbs_off, limb_mismatch."""
    out = {"limbs_off": abs(data.shape[-2] - spec["out_limbs"])}
    shape = (want.shape[0], 2, spec["out_limbs"], spec["N"])
    if tuple(data.shape) != shape:
        out.update(max_abs_err=FAIL, rms_err=FAIL, limb_mismatch=FAIL)
        return out
    s = ckks.secret_key(spec["seed"], spec["N"], spec["hamming_weight"])
    c = ckks.decrypt_coeffs(data, spec["q_primes"], s)
    m, bad = ckks.crt_message(c, spec["q_primes"])
    got = ckks.decode(m, scale)
    err = (got - want.to(got.device)).abs()
    out.update(max_abs_err=float(err.max()),
               rms_err=float(err.square().mean().sqrt()), limb_mismatch=bad)
    return out
