"""Kernel 1 reading the slab's rows from their tables by id (csrc/context.cu
TableRows, kernels/context_pallas.fused_context_rows) on the card: all five
outputs bit-equal to the dense call (fused_context_pallas) on the same rows
gathered and copied from the same tables as the fused step did before, two
launches bit-equal, each call counted once by `fused_context_rows` and by
`fused_context_pallas`.  At the benchmark cells' shapes (wiki: the fused
bf16 table's halves, B 16,384, W 8, tile 256, D 800; text8: D 200, B
8,192), on split float32 tables, at odd widths (the scalar path: a fused
bf16 table whose v half is not 16-byte aligned, and split float32 tables),
on masks with ones outside the band (the span staged in pieces, each
fetching its own row pointers), at bitlevels 1 and 2, with padded slab
positions (id -1 clamped to 0), duplicate ids, and int32 as well as int64
ids.

Marked `cuda`: without a card each test skips.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_context_rows_card.py

(`--noconftest`: tests/conftest.py imports JAX, which the card's machine
does not have; this file does not import it.)
"""

from __future__ import annotations

import pytest
import torch

from word2bits_tpu_torch.kernels.context_pallas import (
    fused_context_pallas, fused_context_rows)
from word2bits_tpu_torch.ops.windowed import _tile_windows, build_banded_masks

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
TILE = 256

# B, W, D, row dtype, fused (one [V, 2D] table and its halves) or split
# tables, mask ("banded", or "random": ~30% ones over every column), id
# dtype
I64, I32 = torch.int64, torch.int32
CASES = {
    "wiki": (16384, 8, 800, BF16, True, "banded", I64),
    "text8": (8192, 8, 200, BF16, True, "banded", I64),
    "text8 int32 ids": (8192, 8, 200, BF16, True, "banded", I32),
    "split float32": (4096, 8, 200, F32, False, "banded", I64),
    "odd D fused bf16": (1024, 8, 37, BF16, True, "banded", I64),
    "odd D split float32": (1024, 5, 37, F32, False, "banded", I32),
    "pieces bf16": (4096, 8, 200, BF16, True, "random", I64),
    "pieces float32 D 800": (1024, 8, 800, F32, False, "random", I64),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_context_rows_card.py there")
    return torch.device("cuda")


def _inputs(dev, B, W, D, dtype, fused, mask, id_dtype):
    """(u_tab, v_tab, slab_ids, Mb, valid, alpha): a seeded table of
    4 (B + 2W) rows, ids drawn from it with duplicates and the last 5
    positions padding (id 0, sentence -1), sentences of ~20 tokens, the
    banded masks of random shrinks or a random 0/1 mask."""
    gen = torch.Generator(device=dev).manual_seed(B + D)
    n = B + 2 * W
    table = (torch.randn((4 * n, 2 * D), generator=gen, device=dev)
             * 0.3).to(dtype)
    if fused:
        u_tab, v_tab = table[:, :D], table[:, D:]
    else:
        u_tab, v_tab = table[:, :D].contiguous(), table[:, D:].contiguous()
    ids = torch.randint(0, 4 * n, (n,), generator=gen, device=dev)
    ids[-5:] = -1
    sents = torch.arange(n, device=dev) // 20
    sents[-5:] = -1
    shrink = torch.randint(0, W, (B,), generator=gen, device=dev)
    Mb, _, valid = build_banded_masks(sents, shrink, B, W, TILE)
    if mask == "random":
        Mb = (torch.rand(Mb.shape, generator=gen, device=dev) < 0.3).to(F32)
        Mb.view(B, -1)[::37] = 0.0
    return (u_tab, v_tab, ids.clamp_min(0).to(id_dtype), Mb,
            valid.to(F32)[:, None], torch.full((1, 1), 0.1, device=dev))


def _dense(u_tab, v_tab, ids, Mb, valid, alpha, bitlevel):
    """The dense call on the rows as the fused step fed it before: the
    slab's rows gathered, the tile windows and center rows copied."""
    Nt, tile, F = Mb.shape
    W, B = (F - tile) // 2, Nt * tile
    uwin3 = _tile_windows(u_tab[ids], Nt, tile, W).contiguous()
    return fused_context_pallas(uwin3, v_tab[ids[W:W + B]].contiguous(), Mb,
                                valid, alpha, bitlevel)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.int32)


@pytest.mark.parametrize("bitlevel", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_by_id_is_the_dense_call_bit_for_bit(card, case, bitlevel):
    args = _inputs(card, *CASES[case])
    before = (fused_context_pallas.launches, fused_context_rows.launches)
    got = fused_context_rows(*args, bitlevel)
    again = fused_context_rows(*args, bitlevel)
    want = _dense(*args, bitlevel)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("cavg", "cavge", "dv_center", "af", "loss"),
                             got, again, want):
        assert torch.equal(_bits(g), _bits(w)), name
        assert torch.equal(_bits(a), _bits(g)), name
    assert float(got[3].sum()) > 0, "no active center"
    assert (fused_context_pallas.launches - before[0],
            fused_context_rows.launches - before[1]) == (3, 2)
