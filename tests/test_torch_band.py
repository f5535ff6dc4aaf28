"""The band that kernel 1 (csrc/context.cu) relies on for its speed.

ops/windowed.build_banded_masks puts a one at M[t, i, j] only where slab
position t*tile + j lies in center t*tile + i's shrunk window, so inside
[i, i + 2W] and never at j = i + W (the center itself): each row has at
most 2W ones, and the kernel stages only rows [g0, g0 + G + 2W) for a group
of G centers.  Held over random sentences (padding included), shrinks,
windows and tiles; the JAX function gives the same masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.ops.windowed import build_banded_masks as jmasks
from word2bits_tpu_torch.ops.windowed import build_banded_masks, pick_tile


def _case(seed: int):
    rng = np.random.default_rng(seed)
    W = int(rng.integers(1, 9))
    tile = pick_tile(int(rng.choice([32, 64, 96, 128])), W,
                     int(rng.choice([16, 32, 48, 64, 128])))
    B = tile * int(rng.integers(1, 5))
    n = B + 2 * W
    # sentences of random lengths, a padded stretch (-1) at either end
    sents = np.cumsum(rng.random(n) < rng.uniform(0.02, 0.5)).astype(np.int64)
    sents[:int(rng.integers(0, W + 1))] = -1
    sents[n - int(rng.integers(0, W + 1)):] = -1
    shrink = rng.integers(0, W, B).astype(np.int64)
    return sents, shrink, B, W, tile


@pytest.mark.parametrize("seed", range(16))
def test_banded_masks_stay_in_the_band(seed):
    sents, shrink, B, W, tile = _case(seed)
    M, _, valid = build_banded_masks(torch.from_numpy(sents),
                                     torch.from_numpy(shrink), B, W, tile)
    M = M.numpy()
    Nt, F = B // tile, tile + 2 * W
    assert M.shape == (Nt, tile, F)
    assert set(np.unique(M)) <= {0.0, 1.0}
    i = np.arange(tile)[:, None]
    j = np.arange(F)[None, :]
    o = j - i - W
    band = (o >= -W) & (o <= W) & (o != 0)            # [i, i+2W] \ {i+W}
    assert not M[:, ~band].any()
    # the shrunk window, and only real tokens of the center's sentence
    shrunk = np.abs(o)[None] <= (W - shrink.reshape(Nt, tile))[..., None]
    assert not (M.astype(bool) & ~shrunk).any()
    cw = M.sum(axis=2)
    assert cw.max(initial=0) <= 2 * W
    assert np.all(cw[~valid.numpy().reshape(Nt, tile)] == 0)
    # so a group of G centers reaches rows [g0, g0 + G + 2W) only
    G = 16
    for g0 in range(0, tile, G):
        cols = np.flatnonzero(M[:, g0:g0 + G].any(axis=(0, 1)))
        if cols.size:
            assert cols.min() >= g0 and cols.max() < g0 + G + 2 * W


@pytest.mark.parametrize("seed", range(4))
def test_banded_masks_equal_jax_masks(seed):
    sents, shrink, B, W, tile = _case(100 + seed)
    got = build_banded_masks(torch.from_numpy(sents),
                             torch.from_numpy(shrink), B, W, tile)
    want = jmasks(jnp.asarray(sents.astype(np.int32)),
                  jnp.asarray(shrink.astype(np.int32)), B, W, tile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
