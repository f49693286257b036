"""moai_tpu_torch.minimax is a copy of moai_tpu.minimax: every function
gives outputs equal to the original's on the same arguments, and the
cosine fit it compares against (``boot.evalmod.fit_cos_multi_interval``)
equals the JAX package's."""

import numpy as np
import pytest
import torch

from moai_tpu import minimax as jmm
from moai_tpu.boot import evalmod as jevalmod
from moai_tpu_torch import minimax as mm
from moai_tpu_torch.boot import evalmod

torch.set_num_threads(1)


def _equal(a, b):
    """Nested tuples/lists of arrays and floats, equal element for element."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name, args, kwargs", [
    ("remez_fit", (np.exp, [(-1.0, 1.0)], 10), {}),
    ("remez_fit", (np.sign, [(-1.0, -0.2), (0.2, 1.0)], 9),
     {"parity": "odd"}),
    ("remez_fit", (np.abs, [(-1.0, -0.1), (0.1, 1.0)], 8),
     {"parity": "even", "n_grid_per": 512}),
    ("fit_sign_composite", (1 / 60, [9, 9, 9, 9]), {}),
    ("fit_sign_composite", (0.05, [7, 15]), {"margin": 1e-3}),
    ("choose_sign_composite", (0.1, 1e-3), {"max_stages": 3}),
    ("eval_cheb_np", (np.array([0.3, -1.0, 0.5, 0.25]),
                      np.linspace(-1, 1, 101)), {}),
    ("fit_cos_remez", (2, 2 ** -6, 24, 2), {}),
])
def test_minimax_matches_jax(name, args, kwargs):
    assert _equal(getattr(mm, name)(*args, **kwargs),
                  getattr(jmm, name)(*args, **kwargs))


def test_fit_cos_multi_interval_matches_jax():
    assert _equal(evalmod.fit_cos_multi_interval(3, 2 ** -6, 30, 2),
                  jevalmod.fit_cos_multi_interval(3, 2 ** -6, 30, 2))
