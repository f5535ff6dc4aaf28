"""Kernels 2 and 7 reading the fused CBOW step's update rows from their
three parts (kernels/span_scatter.RowParts, csrc/w2b_rows.cuh SlabParts)
on the card: the table bit-equal to the same kernel's on the same rows
materialized by `RowParts.materialize` (torch.cat), two launches
bit-equal, one launch a call counted by the kernel's wrapper and by
`launch_parts`.  At the benchmark cells' shapes (wiki: a bf16 table, B
16,384, W 8, D 800, 6,144 negative rows; text8: D 200), on a float32
table, on bf16 rows, at an odd width and with a part that is not 16-byte
aligned (one column a thread), at W 0, with no negative rows, and with
one id holding every row; every case has ids at or past V (dropped).

Marked `cuda`: without a card each test skips.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_row_parts_card.py

(`--noconftest`: tests/conftest.py imports JAX, which the card's machine
does not have; this file does not import it.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from word2bits_tpu_torch.kernels import group_rmw, span_scatter
from word2bits_tpu_torch.kernels.span_scatter import (
    SENTINEL, RowParts, launch_parts, sort_plan)

pytestmark = pytest.mark.cuda

WRAPPERS = {"span": span_scatter.scatter_add_span_planned,
            "grmw": group_rmw.scatter_add_grmw_planned}
BF16, F32 = torch.bfloat16, torch.float32

# V, B, W, D, negative rows, table dtype, part dtype, the part set off
# by 4 bytes (None: all aligned), ids ("zipf" or "one id")
CASES = {
    "wiki": (200_000, 16384, 8, 800, 6144, BF16, F32, None, "zipf"),
    "text8": (71_291, 8192, 8, 200, 6144, BF16, F32, None, "zipf"),
    "float32 table": (70_000, 8192, 8, 200, 6144, F32, F32, None, "zipf"),
    "bf16 parts": (70_000, 2048, 8, 200, 1536, BF16, BF16, None, "zipf"),
    "odd D": (5_000, 1024, 8, 37, 768, BF16, F32, None, "zipf"),
    "unaligned dv_neg": (5_000, 1024, 8, 200, 768, BF16, F32, 2, "zipf"),
    "unaligned du_slab": (5_000, 1024, 8, 200, 768, F32, F32, 0, "zipf"),
    "W 0": (5_000, 1024, 0, 200, 768, BF16, F32, None, "zipf"),
    "no negative rows": (5_000, 1024, 8, 200, 0, BF16, F32, None, "zipf"),
    "one id": (5_000, 2048, 8, 200, 1536, BF16, F32, None, "one id"),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_row_parts_card.py there")
    return torch.device("cuda")


def _case(dev, V, B, W, D, n_neg, tdt, pdt, shifted, ids_kind):
    """(table, plan, parts): a seeded table, the plan of the step's ids
    (5% drop sentinels and 3% at V among them) and float32 parts at the
    step's scale, cast to pdt; part `shifted` sits 4 bytes past an aligned
    start."""
    rng = np.random.default_rng(V + B + D)
    n_slab = B + 2 * W
    n = n_slab + n_neg
    if ids_kind == "one id":
        ids = np.full(n, 7)
    else:
        ids = np.minimum(rng.zipf(1.1, size=n) - 1, V - 1)
    ids[rng.random(n) < 0.05] = SENTINEL
    ids[rng.random(n) < 0.03] = V
    gen = torch.Generator(device=dev).manual_seed(D)
    table = ((torch.rand((V, 2 * D), generator=gen, device=dev) - 0.5)
             .to(tdt))
    parts = []
    for i, rows in enumerate((n_slab, B, n_neg)):
        buf = torch.randn(rows * D + 1, generator=gen, device=dev) * 0.01
        off = 1 if shifted == i else 0
        parts.append(buf[off:off + rows * D].view(rows, D).to(pdt))
    plan = sort_plan(torch.from_numpy(ids).to(dev))
    return table, plan, RowParts(*parts, W)


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.reshape(-1)
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("kernel", list(WRAPPERS))
@pytest.mark.parametrize("case", list(CASES))
def test_parts_equal_the_materialized_rows(card, kernel, case):
    table0, plan, parts = _case(card, *CASES[case])
    shifted = CASES[case][7]
    if shifted is not None:
        assert parts[shifted].data_ptr() % 16, "the part is aligned"
    run = WRAPPERS[kernel]
    before = (run.launches, launch_parts.launches)
    got = run(table0.clone(), plan, parts)
    again = run(table0.clone(), plan, parts)
    want = run(table0.clone(), plan, parts.materialize())
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(again), _bits(got))
    assert not torch.equal(got, table0)
    assert (run.launches - before[0], launch_parts.launches - before[1]) \
        == (3, 2)
