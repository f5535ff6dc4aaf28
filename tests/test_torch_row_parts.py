"""The fused CBOW step's update rows as their three parts
(kernels/span_scatter.RowParts), on the CPU.

The step hands kernels 2 and 7 (the `span` and `grmw` routes) the three
buffers its phases wrote, and the kernels read them in place
(csrc/w2b_rows.cuh SlabParts; tests/test_torch_row_parts_card.py holds
them bit-equal to the same rows materialized, on the card).  Here:
`RowParts.materialize` is the step's former assembly byte for byte; the
wrappers take RowParts on CPU tables through that assembly and the plain
version, launching nothing; the step hands the scatter its parts, and
gives the table and loss of the same step fed the materialized rows; and
the checks made before a launch (`check_parts`) refuse what the kernels
do not take.
"""

import numpy as np
import pytest
import torch

from word2bits_tpu_torch.kernels import group_rmw, span_scatter
from word2bits_tpu_torch.kernels.span_scatter import (
    SENTINEL, RowParts, check_parts, launch_parts, sort_plan)
from word2bits_tpu_torch.models import cbow_fused
from word2bits_tpu_torch.models.cbow import CBOWHyper
from word2bits_tpu_torch.models.cbow_slab import SlabInputs

WRAPPERS = {"span": span_scatter.scatter_add_span_planned,
            "grmw": group_rmw.scatter_add_grmw_planned}


def _assembled(du_slab, dv_center, dv_neg, W):
    """The rows as models/cbow_fused.py assembled them before the kernels
    read the parts: a zero-filled dv_slab given the center rows, then two
    concatenations, and the negative rows' zero u half."""
    B, D = dv_center.shape
    dv_slab = torch.zeros((B + 2 * W, D), dtype=torch.float32)
    dv_slab[W:W + B] = dv_center
    fused_rows = torch.cat([du_slab, dv_slab], dim=1)
    v_rows = torch.cat([torch.zeros_like(dv_neg), dv_neg], dim=1)
    return torch.cat([fused_rows, v_rows])


def _parts(rng, B, W, D, n_neg) -> RowParts:
    def f32(n):
        return torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32))
    return RowParts(f32(B + 2 * W), f32(B), f32(n_neg), W)


def _bytes(t: torch.Tensor) -> bytes:
    return t.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("B,W,D,n_neg", [
    (64, 3, 16, 40), (64, 0, 16, 40), (8, 8, 37, 0), (1, 1, 1, 5),
    (256, 8, 200, 192)])
def test_materialize_is_the_step_assembly(rng, B, W, D, n_neg):
    parts = _parts(rng, B, W, D, n_neg)
    got, want = parts.materialize(), _assembled(*parts)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.shape == (B + 2 * W + n_neg, 2 * D)
    assert _bytes(got) == _bytes(want)


def _ids(rng, V, n):
    """Zipf ids with duplicates, some at or past V (dropped)."""
    ids = np.minimum(rng.zipf(1.2, size=n) - 1, V - 1)
    ids[rng.random(n) < 0.05] = SENTINEL
    ids[rng.random(n) < 0.03] = V
    return torch.from_numpy(ids.astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_cpu_wrapper_materializes_the_parts(rng, kernel, dtype):
    V, B, W, D, n_neg = 50, 32, 3, 8, 24
    parts = _parts(rng, B, W, D, n_neg)
    ids = _ids(rng, V, B + 2 * W + n_neg)
    table = torch.from_numpy(rng.normal(size=(V, 2 * D)).astype(
        np.float32)).to(dtype)
    before = (launch_parts.launches, WRAPPERS[kernel].launches)
    got = WRAPPERS[kernel](table.clone(), sort_plan(ids), parts)
    want = span_scatter.scatter_add_span_plain(table.clone(), ids,
                                               _assembled(*parts))
    assert _bytes(got) == _bytes(want)
    assert (launch_parts.launches, WRAPPERS[kernel].launches) == before


# the step: a fused bf16 table, shared negatives in 2 pools
V, D, B, W, K, G, P = 300, 16, 64, 3, 5, 8, 2


def _step(table, inputs, route, ctx):
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    return cbow_fused.fused_slab_step(
        table, inputs, torch.tensor(0.05), hyper, B, G, neg_pool=P,
        banded=8, scatter_impl=route, context_pallas=ctx)


@pytest.mark.parametrize("ctx", [True, False])
@pytest.mark.parametrize("route", list(WRAPPERS))
def test_step_hands_the_scatter_its_parts(rng, monkeypatch, route, ctx):
    """The span/grmw step passes RowParts (u of the slab, v of the centers
    and of the negatives) and gives the table and loss of the same step
    whose scatter is fed the rows materialized."""
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (V, 2 * D)).astype(
        np.float32)).to(torch.bfloat16)
    toks = rng.integers(-1, V, B + 2 * W)
    sents = np.sort(rng.integers(-1, 5, B + 2 * W))
    inputs = SlabInputs(
        slab_tokens=torch.from_numpy(toks), slab_sents=torch.from_numpy(sents),
        shrink=torch.from_numpy(rng.integers(0, W, B)),
        neg_ids=torch.from_numpy(rng.integers(1, V, (B // G, P * K))))
    name = f"scatter_add_{route}_planned"
    wrapper = getattr(cbow_fused, name)
    handed = []

    def spy(t, plan, rows, **kw):
        handed.append(rows)
        return wrapper(t, plan, rows, **kw)

    def dense(t, plan, rows, **kw):
        return wrapper(t, plan, rows.materialize(), **kw)

    monkeypatch.setattr(cbow_fused, name, spy)
    got, loss = _step(table.clone(), inputs, route, ctx)
    monkeypatch.setattr(cbow_fused, name, dense)
    want, want_loss = _step(table.clone(), inputs, route, ctx)
    (parts,) = handed
    assert isinstance(parts, RowParts) and parts.window == W
    assert parts.du_slab.shape == (B + 2 * W, D)
    assert parts.dv_center.shape == (B, D)
    assert parts.dv_neg.shape == (B // G * P * K, D)
    assert all(t.dtype == torch.float32 for t in parts[:3])
    assert _bytes(got) == _bytes(want)
    assert _bytes(loss) == _bytes(want_loss)
    assert not torch.equal(got, table)


def _parts_call(rng, bad="none"):
    """(table, plan, parts) of a three-part scatter, broken by `bad`."""
    V, B, W, D, n_neg = 40, 16, 2, 8, 12
    parts = _parts(rng, B, W, D, n_neg)
    table = torch.zeros((V, 2 * D))
    plan = sort_plan(_ids(rng, V, B + 2 * W + n_neg))
    du, dvc, dvn, _ = parts
    if bad == "table dtype":
        table = table.double()
    elif bad == "row dtype":
        parts = RowParts(du.half(), dvc.half(), dvn.half(), W)
    elif bad == "parts in two dtypes":
        parts = parts._replace(dv_neg=dvn.to(torch.bfloat16))
        table = table.to(torch.bfloat16)
    elif bad == "width":
        parts = parts._replace(dv_center=dvc[:, :D - 1].contiguous())
    elif bad == "odd table width":
        table = torch.zeros((V, 2 * D + 1))
    elif bad == "window":
        parts = parts._replace(window=W + 1)
    elif bad == "negative rows":
        parts = parts._replace(dv_neg=dvn[:-1])
    elif bad == "batched plan":
        plan = sort_plan(plan.sids.long()[None])
    elif bad == "plan dtype":
        plan = plan._replace(sids=plan.sids.long())
    elif bad == "not contiguous":
        parts = parts._replace(du_slab=du.t().contiguous().t())
    elif bad == "device":
        parts = parts._replace(dv_neg=dvn.to("meta"))
    return table, plan, parts


@pytest.mark.parametrize("bad", [
    "table dtype", "row dtype", "parts in two dtypes", "width",
    "odd table width", "window", "negative rows", "batched plan",
    "plan dtype", "not contiguous", "device"])
def test_check_parts_raises_on_what_the_kernels_do_not_take(rng, bad):
    table, plan, parts = _parts_call(rng, bad)
    with pytest.raises(ValueError, match="scatter_add_grmw"):
        check_parts("scatter_add_grmw", table, plan, parts)


def test_check_parts_takes_a_good_call(rng):
    table, plan, parts = _parts_call(rng)
    check_parts("scatter_add_span", table, plan, parts)
    bf16 = RowParts(*(t.to(torch.bfloat16) for t in parts[:3]), parts.window)
    for rows in (parts, bf16):
        check_parts("scatter_add_span", table.to(torch.bfloat16), plan, rows)
