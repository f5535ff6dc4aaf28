"""The banded u-sum (kernels/band_usum.py) on the CPU: its plain version is
ops/windowed.banded_usum on the af-weighted mask, equal to the JAX
package's banded_usum within 1e-5 (same products, another summation
order) and `cnt` exactly; the wrapper refuses what the kernel does not take
before any launch; the masks the step builds are zero outside the band the
kernel reads.  The kernel itself: tests/test_torch_band_usum_card.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu_torch.kernels import band_usum as tbu
from word2bits_tpu_torch.ops import windowed as twin

jwin = importlib.import_module("word2bits_tpu.ops.windowed")


def _masks(rng, B, W, tile, kind):
    """(Mb [B/tile, tile, tile+2W], af [B]) float32: the step's masks on
    sentences with breaks and -1 padding, or random 0/1 inside the band;
    some active flags 0."""
    n = B + 2 * W
    if kind == "built":
        sents = np.sort(rng.integers(-1, 6, n))
        shrink = rng.integers(0, W, B)
        Mb, _, valid = twin.build_banded_masks(
            torch.from_numpy(sents), torch.from_numpy(shrink), B, W, tile)
    else:
        Nt, F = B // tile, tile + 2 * W
        o = np.arange(F)[None, :] - np.arange(tile)[:, None]
        band = (o >= 0) & (o <= 2 * W)
        Mb = torch.from_numpy(
            (rng.random((Nt, tile, F)) < 0.5) & band[None]).float()
        valid = torch.ones(B, dtype=torch.bool)
    af = valid.float() * torch.from_numpy(rng.random(B) < 0.8).float()
    return Mb, af


SHAPES = [(64, 3, 8, 16), (60, 3, 6, 5), (96, 4, 16, 37), (32, 1, 4, 8)]


@pytest.mark.parametrize("kind", ["built", "random"])
@pytest.mark.parametrize("with_cnt", [False, True])
@pytest.mark.parametrize("B,W,tile,D", SHAPES)
def test_plain_matches_windowed_and_jax(rng, B, W, tile, D, with_cnt, kind):
    Mb, af = _masks(rng, B, W, tile, kind)
    cav = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    before = tbu.band_usum.launches
    du, cnt = tbu.band_usum(Mb, af, cav, W, with_cnt)
    assert tbu.band_usum.launches == before   # CPU: plain version
    M_af = Mb * af.reshape(B // tile, tile)[:, :, None]
    want_du, want_cnt = twin.banded_usum(M_af, cav, B, W)
    assert du.shape == (B + 2 * W, D) and du.dtype == torch.float32
    torch.testing.assert_close(du, want_du, rtol=0, atol=0)
    duj, cnj = jwin.banded_usum(jnp.asarray(M_af.numpy()),
                                jnp.asarray(cav.numpy()), B, W)
    np.testing.assert_allclose(du.numpy(), np.asarray(duj), atol=1e-5,
                               rtol=1e-5)
    if with_cnt:
        torch.testing.assert_close(cnt, want_cnt, rtol=0, atol=0)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnj))
    else:
        assert cnt is None


def _refused(B=64, W=3, tile=8, D=16):
    Mb, af = _masks(np.random.default_rng(0), B, W, tile, "built")
    cav = torch.zeros((B, D))
    return {
        "cavge float64": (Mb, af, cav.double(), W),
        "Mb bfloat16": (Mb.bfloat16(), af, cav, W),
        "af float64": (Mb, af.double(), cav, W),
        "cavge not contiguous": (Mb, af, torch.zeros((D, B)).t(), W),
        "Mb not contiguous": (Mb.transpose(0, 1).contiguous().transpose(0, 1),
                              af, cav, W),
        "Mb of another W": (Mb, af, cav, W - 1),
        "Mb flat": (Mb.reshape(B, -1), af, cav, W),
        "cavge rows": (Mb, af, cav[:-1], W),
        "af rows": (Mb, af[:-1], cav, W),
        "tile < 2W": (torch.zeros((B // 4, 4, 4 + 2 * W)), af, cav, W),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_wrapper_refuses(case):
    args = _refused()[case]
    before = tbu.band_usum.launches
    with pytest.raises(ValueError, match="band_usum"):
        tbu.band_usum(*args, with_cnt=True)
    assert tbu.band_usum.launches == before


@pytest.mark.parametrize("tile", [6, 8, 64])
def test_built_masks_zero_outside_band(rng, tile):
    """The kernel reads only the band [i, i + 2W] of center row i: the
    step's masks, on random shrinks and sentences, set nothing outside."""
    B, W = 192, 3
    Mb, _ = _masks(rng, B, W, tile, "built")
    o = torch.arange(tile + 2 * W)[None, :] - torch.arange(tile)[:, None]
    outside = (o < 0) | (o > 2 * W)
    assert Mb.sum() > 0
    assert not Mb[:, outside].any()
