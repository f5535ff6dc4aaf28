"""The port's score kernel module == the JAX Pallas score kernel (CPU).

`quantized_scores_plain` (and the wrapper, which runs it for CPU tensors)
against the JAX package's `quantized_scores_pallas` in interpret mode on
the same numpy inputs: pools P in {1, 4}, reg in {0, 0.01}, bitlevels 1
and 2; atol 1e-5 as in tests/test_slab_pallas.py (the products' float
order differs).  The CUDA kernel runs only on the card, where
chip_smoke.py's [score] phase holds it against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.kernels.score_pallas import (
    quantized_scores_pallas as jscore)
from word2bits_tpu_torch.kernels import score_pallas as tscore

T, G, K, D = 6, 8, 3, 16


def _inputs(rng, P):
    cavg3 = rng.normal(scale=0.3, size=(T, G, D)).astype(np.float32)
    v_rows = rng.uniform(-0.9, 0.9, (T, P * K, D)).astype(np.float32)
    centers3 = rng.integers(0, 20, (T, G)).astype(np.int32)
    negs = rng.integers(0, 20, (T, P * K)).astype(np.int32)
    negs[0, 0] = centers3[0, 0]           # a skipped (center == negative)
    af3 = (rng.random((T, G)) < 0.85).astype(np.float32)
    scalars = np.full((1, 1), 0.05, np.float32)
    return cavg3, v_rows, centers3, negs, af3, scalars


def _torch(args):
    cavg3, v_rows, centers3, negs, af3, scalars = args
    return (torch.from_numpy(cavg3), torch.from_numpy(v_rows),
            torch.from_numpy(centers3).long(), torch.from_numpy(negs).long(),
            torch.from_numpy(af3), torch.from_numpy(scalars))


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("reg", [0.0, 0.01])
@pytest.mark.parametrize("bitlevel", [1, 2])
def test_scores_plain_matches_pallas(rng, P, reg, bitlevel):
    args = _inputs(rng, P)
    want = jscore(*(jnp.asarray(a) for a in args), bitlevel, reg, P, True)
    for fn in (tscore.quantized_scores_plain, tscore.quantized_scores_pallas):
        got = fn(*_torch(args), bitlevel, reg, P)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-5,
                                   rtol=1e-6)


def test_scores_wrapper_counts_only_launches(rng):
    before = tscore.quantized_scores_pallas.launches
    tscore.quantized_scores_pallas(*_torch(_inputs(rng, 2)), 1, 0.0, 2)
    assert tscore.quantized_scores_pallas.launches == before


def test_scores_rejects_bad_bitlevel(rng):
    with pytest.raises(ValueError, match="bitlevel"):
        tscore.quantized_scores_pallas(*_torch(_inputs(rng, 1)), -1, 0.0, 1)
