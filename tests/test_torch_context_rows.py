"""Kernel 1 reading the slab's rows from their tables by id
(kernels/context_pallas.fused_context_rows), on the CPU.

On the card the fused and split CBOW steps hand kernel 1 the tables and
the slab's ids, and the kernel reads each window row and center row by id
(csrc/context.cu TableRows; tests/test_torch_context_rows_card.py holds it
bit-equal to the dense call on the same rows, on the card).  Here: the
by-id entry's plain version is fused_context_plain on the windows gathered
from the tables; one step of each route that runs kernel 1 gives the table
and loss of the same step fed the gathered rows, as the step fed them
before; the CPU launches nothing; and the checks made before a launch
refuse what the kernel does not take.
"""

import numpy as np
import pytest
import torch

from word2bits_tpu_torch.kernels import context_pallas
from word2bits_tpu_torch.kernels.context_pallas import (
    fused_context_pallas, fused_context_plain, fused_context_rows)
from word2bits_tpu_torch.models import cbow_fused, cbow_slab
from word2bits_tpu_torch.models.cbow import CBOWHyper
from word2bits_tpu_torch.models.cbow_slab import SlabInputs
from word2bits_tpu_torch.ops.windowed import (_tile_windows,
                                              build_banded_masks)


def _bytes(t: torch.Tensor) -> bytes:
    return t.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


def _inputs(rng, V, B, W, D, tile, dtype, fused, pad=0):
    """(u_tab, v_tab, slab_ids, Mb, valid, scalars): a seeded table (one
    fused [V, 2D] table and its halves, or split [V, D] tables), slab ids
    with duplicates and `pad` padding positions at the end (-1, clamped to
    0 as the step clamps them), sentences of ~6 tokens."""
    n = B + 2 * W
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (V, 2 * D)).astype(
        np.float32)).to(dtype)
    if fused:
        u_tab, v_tab = table[:, :D], table[:, D:]
    else:
        u_tab, v_tab = table[:, :D].contiguous(), table[:, D:].contiguous()
    ids = rng.integers(0, V, n)
    sents = np.arange(n) // 6
    if pad:
        ids[-pad:], sents[-pad:] = -1, -1
    Mb, _, valid = build_banded_masks(
        torch.from_numpy(sents), torch.from_numpy(rng.integers(0, W, B)),
        B, W, tile)
    return (u_tab, v_tab, torch.from_numpy(ids).clamp_min(0), Mb,
            valid.to(torch.float32)[:, None], torch.full((1, 1), 0.05))


CASES = {
    "fused bf16": (400, 64, 3, 16, 16, torch.bfloat16, True, 0),
    "split f32": (400, 64, 3, 16, 16, torch.float32, False, 0),
    "padded": (400, 64, 3, 16, 32, torch.bfloat16, True, 4),
    "odd D": (90, 32, 2, 37, 8, torch.float32, True, 2),
    "W 8, tile 256": (3000, 512, 8, 24, 256, torch.bfloat16, True, 5),
}


def test_rows_plain_takes_int32_ids(rng):
    """int32 ids (a chunk's tokens may be int32) read the same rows."""
    u_tab, v_tab, ids, Mb, valid, sc = _inputs(rng, *CASES["padded"])
    got = fused_context_rows(u_tab, v_tab, ids.to(torch.int32), Mb, valid,
                             sc, 1)
    want = fused_context_rows(u_tab, v_tab, ids, Mb, valid, sc, 1)
    for g, w in zip(got, want):
        assert _bytes(g) == _bytes(w)


@pytest.mark.parametrize("bitlevel", [0, 1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_rows_plain_is_the_plain_version_on_gathered_windows(rng, case,
                                                             bitlevel):
    V, B, W, D, tile, dtype, fused, pad = CASES[case]
    u_tab, v_tab, ids, Mb, valid, sc = _inputs(rng, *CASES[case])
    got = fused_context_rows(u_tab, v_tab, ids, Mb, valid, sc, bitlevel)
    uwin3 = _tile_windows(u_tab[ids], B // tile, tile, W).contiguous()
    want = fused_context_plain(uwin3, v_tab[ids[W:W + B]].contiguous(), Mb,
                               valid, sc, bitlevel)
    for g, w in zip(got, want):
        assert _bytes(g) == _bytes(w)


def test_rows_plain_clamps_ids_into_the_table(rng):
    """Ids below 0 read row 0 and ids at or past V row V - 1, as the
    kernel clamps them."""
    u_tab, v_tab, ids, Mb, valid, sc = _inputs(rng, *CASES["fused bf16"])
    V = u_tab.shape[0]
    wild = ids.clone()
    wild[:5], wild[-5:] = -7, V + 3
    fixed = ids.clone()
    fixed[:5], fixed[-5:] = 0, V - 1
    got = fused_context_rows(u_tab, v_tab, wild, Mb, valid, sc, 1)
    want = fused_context_rows(u_tab, v_tab, fixed, Mb, valid, sc, 1)
    for g, w in zip(got, want):
        assert _bytes(g) == _bytes(w)


def test_cpu_launches_nothing(rng):
    args = _inputs(rng, *CASES["fused bf16"])
    before = (fused_context_pallas.launches, fused_context_rows.launches)
    fused_context_rows(*args, 1)
    assert (fused_context_pallas.launches,
            fused_context_rows.launches) == before


def _dense_route(u_rows, vc_rows, slab_ids, Mb, valid, scalars, bitlevel):
    """The step's former route to kernel 1: the slab's rows gathered, the
    tile windows and center rows copied, the dense call."""
    Nt, tile, F = Mb.shape
    W, B = (F - tile) // 2, Nt * tile
    rows = u_rows[slab_ids]
    return fused_context_pallas(
        _tile_windows(rows, Nt, tile, W).contiguous(),
        vc_rows[slab_ids[W:W + B]].contiguous(), Mb, valid, scalars,
        bitlevel)


# the steps: a fused bf16 table (split f32 tables for slab_step), shared
# negatives in 2 pools
V, D, B, W, K, G, P = 300, 16, 64, 3, 5, 8, 2


def _step_inputs(rng):
    toks = rng.integers(-1, V, B + 2 * W)
    sents = np.sort(rng.integers(-1, 5, B + 2 * W))
    return SlabInputs(
        slab_tokens=torch.from_numpy(toks), slab_sents=torch.from_numpy(sents),
        shrink=torch.from_numpy(rng.integers(0, W, B)),
        neg_ids=torch.from_numpy(rng.integers(1, V, (B // G, P * K))))


@pytest.mark.parametrize("route", ["span", "grmw"])
def test_fused_step_by_id_is_the_step_fed_gathered_rows(rng, monkeypatch,
                                                        route):
    """fused_slab_step with the context kernel hands it the table's halves
    and the slab ids, and gives the table and loss of the step that
    gathered and copied the rows for it."""
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (V, 2 * D)).astype(
        np.float32)).to(torch.bfloat16)
    inputs = _step_inputs(rng)
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    handed = []

    def spy(u_rows, vc_rows, slab_ids, *rest):
        handed.append((u_rows, vc_rows, slab_ids))
        return fused_context_rows(u_rows, vc_rows, slab_ids, *rest)

    def step(t):
        return cbow_fused.fused_slab_step(
            t, inputs, torch.tensor(0.05), hyper, B, G, neg_pool=P,
            banded=8, scatter_impl=route, context_pallas=True)

    monkeypatch.setattr(cbow_slab, "fused_context_rows", spy)
    got, loss = step(table.clone())
    monkeypatch.setattr(cbow_slab, "fused_context_rows", _dense_route)
    want, want_loss = step(table.clone())
    ((u_rows, vc_rows, slab_ids),) = handed
    assert u_rows.shape == vc_rows.shape == (V, D)
    assert u_rows.stride() == vc_rows.stride() == (2 * D, 1)
    assert torch.equal(slab_ids, inputs.slab_tokens.clamp_min(0))
    assert _bytes(got) == _bytes(want)
    assert _bytes(loss) == _bytes(want_loss)
    assert not torch.equal(got, table)


def test_split_step_by_id_is_the_step_fed_gathered_rows(rng, monkeypatch):
    """slab_step (split tables, span) with the context kernel hands it u,
    v and the slab ids, with the same tables and loss as the step that
    gathered the rows for it."""
    u0, v0 = (torch.from_numpy(rng.uniform(-0.5, 0.5, (V, D)).astype(
        np.float32)) for _ in range(2))
    inputs = _step_inputs(rng)
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)

    def step():
        return cbow_slab.slab_step(
            u0.clone(), v0.clone(), inputs, torch.tensor(0.05), hyper, B,
            neg_sharing=G, neg_pool=P, banded=8, scatter_impl="span",
            context_pallas=True)

    u, v, loss = step()
    monkeypatch.setattr(cbow_slab, "fused_context_rows", _dense_route)
    wu, wv, wloss = step()
    assert _bytes(u) == _bytes(wu) and _bytes(v) == _bytes(wv)
    assert _bytes(loss) == _bytes(wloss)
    assert not torch.equal(u, u0)


def test_positive_phase_needs_ids_for_the_kernel(rng):
    table = torch.zeros((V, 2 * D))
    inputs = _step_inputs(rng)
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    with pytest.raises(ValueError, match="slab_ids"):
        cbow_slab.positive_phase(table[:B + 2 * W, :D], table[:B, D:],
                                 inputs, torch.tensor(0.05), hyper, B, 8,
                                 True)


def _bad(args, bad):
    """The by-id arguments broken by `bad`."""
    u_tab, v_tab, ids, Mb, valid, sc = args
    if bad == "int16 ids":
        ids = ids.to(torch.int16)
    elif bad == "short ids":
        ids = ids[:-1]
    elif bad == "strided ids":
        ids = torch.stack([ids, ids], 1)[:, 0]
    elif bad == "dtypes differ":
        v_tab = v_tab.to(torch.float32)
    elif bad == "widths differ":
        v_tab = v_tab[:, 1:]
    elif bad == "column stride":
        u_tab = u_tab.t().contiguous().t()
    elif bad == "float16 rows":
        u_tab, v_tab = u_tab.to(torch.float16), v_tab.to(torch.float16)
    elif bad == "f64 masks":
        Mb = Mb.to(torch.float64)
    elif bad == "odd halo":
        Mb = Mb[:, :, :-1].contiguous()
    elif bad == "D over 1024":
        u_tab = v_tab = torch.zeros((8, 1025), dtype=torch.bfloat16)
    return u_tab, v_tab, ids, Mb, valid, sc


@pytest.mark.parametrize("bad", [
    "int16 ids", "short ids", "strided ids", "dtypes differ",
    "widths differ", "column stride", "float16 rows", "f64 masks",
    "odd halo", "D over 1024"])
def test_launch_checks_refuse_what_the_kernel_does_not_take(rng, bad):
    """The checks before a launch raise, before any library is built or
    loaded, on what the kernel does not take."""
    args = _bad(_inputs(rng, *CASES["fused bf16"]), bad)
    with pytest.raises(ValueError, match="fused_context_rows"):
        context_pallas._launch_rows(*args, 1)
