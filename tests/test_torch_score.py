"""The port's score kernel module == the JAX Pallas score kernel (CPU).

`quantized_scores_plain` (and the wrapper, which runs it for CPU tensors)
against the JAX package's `quantized_scores_pallas` in interpret mode on
the same numpy inputs: pools P in {1, 4}, reg in {0, 0.01}, bitlevels 1
and 2; and at the shapes the cluster kernel's design makes risky: ragged
G, P*K and D (G = 9, P*K = 15 in P = 3 pools, D = 37), bitlevels 0, 1, 2,
4 and 8.  atol 1e-5 as in tests/test_slab_pallas.py (the products' float
order differs).  The CUDA kernel runs only on the card, where
chip_smoke.py's [score] and [score edges] phases hold it against the
plain version; the checks its wrapper makes before a launch (`_check`)
are tested here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.kernels.score_pallas import (
    quantized_scores_pallas as jscore)
from word2bits_tpu_torch.kernels import score_pallas as tscore

T, G, K, D = 6, 8, 3, 16


def _inputs(rng, P, T=T, G=G, K=K, D=D):
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


@pytest.mark.parametrize("reg", [0.0, 0.01])
@pytest.mark.parametrize("bitlevel", [0, 1, 2, 4, 8])
def test_scores_plain_matches_pallas_ragged(rng, reg, bitlevel):
    """G = 9 centers, P*K = 15 negatives in P = 3 pools, D = 37: none a
    multiple of the kernel's 4-wide blocks or of its cluster size."""
    P = 3
    args = _inputs(rng, P, T=3, G=9, K=5, D=37)
    want = jscore(*(jnp.asarray(a) for a in args), bitlevel, reg, P, True)
    for fn in (tscore.quantized_scores_plain, tscore.quantized_scores_pallas):
        got = fn(*_torch(args), bitlevel, reg, P)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-5,
                                   rtol=1e-6)


def _bad_score_call(rng, bad):
    """(args, P) of a call that the kernel does not take."""
    P = 2
    args = list(_torch(_inputs(rng, P)))
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "id dtype":
        args[3] = args[3].int()
    elif bad == "shape":
        args[4] = args[4][:, :-1].contiguous()
    elif bad == "not contiguous":
        args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "device":
        args[2] = args[2].to("meta")
    elif bad == "pools":
        P = 4                      # P*K = 6 negatives
    elif bad == "shared memory":
        args = list(_torch(_inputs(rng, P, T=1, G=2048, D=200)))
    return args, P


@pytest.mark.parametrize("bad", [
    "dtype", "id dtype", "shape", "not contiguous", "device", "pools",
    "shared memory"])
def test_score_wrapper_raises_on_what_the_kernel_does_not_take(rng, bad):
    """The checks the wrapper makes before a launch (on a CUDA tensor it
    launches the kernel or raises; it never falls back)."""
    args, P = _bad_score_call(rng, bad)
    with pytest.raises(ValueError):
        tscore._check(*args, P)


def test_score_check_takes_the_shipped_tile(rng):
    """The shipped tile (G = 64, P*K = 48, D = 200) runs on one CTA; the
    capacity configuration's width (D = 800) does not fit one CTA's shared
    memory and takes a cluster of 2, each CTA holding 400 columns."""
    args, P = _bad_score_call(rng, "none")
    tscore._check(*args, P)
    assert tscore.cluster_size(64, 48, 200) == tscore.CLUSTER == 1
    assert tscore.cluster_size(9, 15, 37) == 1
    assert tscore.cluster_size(64, 24, 800) == 2
    assert tscore.cluster_size(2048, 48, 200) == 0
    for G_, PK, D_ in ((64, 48, 200), (64, 24, 800), (9, 15, 37)):
        cl = tscore.cluster_size(G_, PK, D_)
        assert tscore.smem_bytes(G_, PK, D_, cl) <= tscore._SMEM_LIMIT
    # one CTA a tile holds the whole row: more than a CTA of a cluster
    assert (tscore.smem_bytes(64, 48, 200, 1)
            > tscore.smem_bytes(64, 48, 200, 2)
            > tscore.smem_bytes(64, 48, 200, 4))


def test_score_wrapper_raises_off_cpu_and_cuda(rng):
    args, P = _bad_score_call(rng, "none")
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        tscore.quantized_scores_pallas(*(a.to("meta") for a in args), 1,
                                       0.0, P)
