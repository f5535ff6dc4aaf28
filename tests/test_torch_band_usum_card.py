"""The banded u-sum kernel (csrc/band_usum.cu, kernels/band_usum.py) on the
card: within atol 1e-5 + rtol 1e-5 of the float64 sum and of the plain
version, `cnt` equal to the plain version's, two launches bit-equal, one
launch a call, at the benchmark cells' shapes and at the edges (odd and
wide rows, small windows, tile = 2W, padding and sentence breaks, inactive
centers, every shrink at W - 1); and a banded chunk launches it once a
step, replayed or eager.

Marked `cuda`: without a card each test skips.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_band_usum_card.py

(`--noconftest`: tests/conftest.py imports JAX, which the card's machine
does not have; this file does not import it.)
"""

from __future__ import annotations

import pytest
import torch

from word2bits_tpu_torch.kernels.band_usum import band_usum, band_usum_plain
from word2bits_tpu_torch.models import cbow_fused
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.ops.windowed import banded_usum, build_banded_masks
from word2bits_tpu_torch.sampling.unigram import build_alias_table

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_band_usum_card.py there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, D, W, tile, seed, shrink="random", active=0.9):
    """Masks of sentences of random length (mean 20 words) with -1 padding
    at both ends and inside, the step's shrinks, af from the valid centers
    with a share (1 - active) set to 0, float32 cavge rows."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = B + 2 * W
    sents = torch.cumsum((torch.rand(n, generator=g) < 0.05).long(), 0)
    sents[torch.rand(n, generator=g) < 0.01] = -1
    sents[:W] = -1
    sents[-W:] = -1
    if shrink == "random":
        sh = torch.randint(0, W, (B,), generator=g)
    else:
        sh = torch.full((B,), W - 1)
    Mb, _, valid = build_banded_masks(sents.to(dev), sh.to(dev), B, W, tile)
    af = valid.float() * (torch.rand(B, generator=g) < active).float().to(dev)
    cav = torch.randn((B, D), generator=g).to(dev)
    return Mb, af, cav


# (B, D, W, tile, shrink, active share of the centers)
CASES = {
    "wiki": (16384, 800, 8, 256, "random", 0.9),
    "text8": (8192, 200, 8, 256, "random", 0.9),
    "D37": (1024, 37, 8, 256, "random", 0.9),
    "D1600": (2048, 1600, 8, 256, "random", 0.9),
    "W1": (1024, 200, 1, 256, "random", 0.9),
    "W5": (2048, 200, 5, 256, "random", 0.9),
    "tile=2W": (1024, 200, 8, 16, "random", 0.9),
    "shrink W-1": (2048, 200, 8, 256, "max", 0.9),
    "af zeros": (1024, 200, 8, 256, "random", 0.0),
}


@pytest.mark.parametrize("with_cnt", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_float64_and_plain(card, case, with_cnt):
    B, D, W, tile, shrink, active = CASES[case]
    Mb, af, cav = _inputs(card, B, D, W, tile, len(case), shrink, active)
    before = band_usum.launches
    du, cnt = band_usum(Mb, af, cav, W, with_cnt)
    du2, cnt2 = band_usum(Mb, af, cav, W, with_cnt)
    torch.cuda.synchronize()
    assert band_usum.launches == before + 2
    assert torch.equal(du, du2)
    plain_du, plain_cnt = band_usum_plain(Mb, af, cav, W, True)
    M64 = (Mb * af.reshape(B // tile, tile)[:, :, None]).double()
    du64, _ = banded_usum(M64, cav.double(), B, W)
    torch.testing.assert_close(du.double(), du64, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(du, plain_du, atol=1e-5, rtol=1e-5)
    if active == 0.0:
        assert not du.any()
    if with_cnt:
        assert torch.equal(cnt, cnt2)
        assert torch.equal(cnt, plain_cnt)
    else:
        assert cnt is None and cnt2 is None


def test_masks_zero_outside_band(card):
    """The kernel reads only the band [i, i + 2W] of center row i: the
    step's masks on the card, random shrinks and sentences, set nothing
    outside it."""
    for W, tile in ((8, 256), (5, 256), (1, 16), (8, 16)):
        Mb, _, _ = _inputs(card, 4096, 8, W, tile, W + tile)
        o = (torch.arange(tile + 2 * W, device=card)[None, :]
             - torch.arange(tile, device=card)[:, None])
        outside = (o < 0) | (o > 2 * W)
        assert Mb.sum() > 0
        assert not Mb[:, outside].any()


def test_refuses_another_device(card):
    Mb, af, cav = _inputs(card, 512, 8, 8, 256, 3)
    before = band_usum.launches
    with pytest.raises(ValueError, match="band_usum"):
        band_usum(Mb.cpu(), af, cav, 8, False)
    assert band_usum.launches == before


@pytest.mark.parametrize("replay", [True, False])
def test_one_launch_a_banded_step(card, replay, monkeypatch):
    """A fused banded chunk (the wiki cell's route at a small size)
    launches the kernel once a step, its steps replayed from a CUDA graph
    or run eagerly."""
    V, D, B, W, K, G, S = 700, 64, 256, 4, 5, 32, 6
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    with monkeypatch.context() as m:
        if not replay:
            m.setattr(cbow_fused, "eager_reason", lambda *a, **k: "eager")
        chunk = cbow_fused.make_fused_train_chunk(
            hyper, V, B, S, neg_sharing=G, scatter_impl="grmw", banded=64,
            context_pallas=True)
    g = torch.Generator(device="cpu").manual_seed(5)
    table = (torch.randn((V, 2 * D), generator=g) * 0.2).to(card,
                                                            torch.bfloat16)
    n = W + S * B + W
    tokens = torch.randint(1, V, (n,), generator=g)
    sents = torch.cumsum((torch.rand(n, generator=g) < 0.05).long(), 0)
    tokens[:W] = tokens[-W:] = -1
    sents[:W] = sents[-W:] = -1
    atab = build_alias_table(
        torch.arange(V, 0, -1, dtype=torch.float64).numpy() ** 0.75).to(card)
    scalars = ChunkScalars(base0=W, alpha0=0.05, wca_start=0.0,
                           wca_per_step=250.0, denom=1e6)
    gen = torch.Generator(device=card).manual_seed(7)
    before = band_usum.launches
    chunk(table, tokens.to(card), sents.to(card), atab, scalars, gen,
          n_steps=S)
    torch.cuda.synchronize()
    assert band_usum.launches - before == S
    assert chunk.counts.replayed == (S - 1 if replay else 0)
