"""Interleaved-table CBOW step: u and v fused into one (V, 2D) table.

table[:, :D] = u and table[:, D:] = v, so the u rows updated by slab
position and the v rows updated for the centers carry the same word ids and
go out in ONE scatter of B+2W double-width rows; the center v rows ride the
slab gather.  Semantics are those of the JAX package's
models/cbow_fused.py: shared negatives (neg_sharing > 0) with pools,
through the fused score kernel (`use_pallas`) or its plain version; the
banded or shifted-sum windowed sums, with or without the fused context
kernel; and every parameter-update route of its step:

- the `add` (ops/scatter.scatter_add), `span` (sorted kernel, the shipped
  throughput
  configuration), `grmw` (sorted group-RMW kernel, the 3.7M x 800d
  capacity configuration) or `sweep` (kernel 9, kernels/sweep_scatter.py,
  which the JAX package keeps behind the span scatter and its config
  rejects) scatter;
- `rmw_scatter` (kernel 8, kernels/scatter_pallas.py, the earlier capacity
  path) and `dedup_block` (ops/scatter.py), each called for the slab rows
  and then for the negative rows, as the JAX step calls its `scat`;
- the hot/cold split (`hot_rows`): with a cold-position map the rows of
  ids < hot_rows go to the dense head accumulation (kernel 6,
  kernels/hot_pallas.py, with `hot_pallas`; else ops/scatter.hot_slice_add)
  and the slab's cold rows scatter compacted; without one (the JAX
  package's device epoch, which the auto -device-epoch picks for
  -neg-dense-hot) the slab keeps the plain scatter;
- the stratified negatives (`strat_lanes`: importance-weighted lanes, the
  hot ones joining the head accumulation) and the dense hot stratum
  (`dense_hot`: every center scored against all H hot words, three
  [B, H] products in float32, its v delta folded into the head).

The context, positive, negative and u-sum phases are the slab step's
(models/cbow_slab.py).

PyTorch idiom: the table is updated IN PLACE (JAX donates it), the S steps
of a chunk are a Python loop, and the chunk's randomness comes from an
explicit torch.Generator — drawn at chunk entry for all S steps, or
injected by the caller.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from word2bits_tpu_torch.kernels.group_rmw import scatter_add_grmw_planned
from word2bits_tpu_torch.kernels.hot_pallas import (HotPlan, hot_plan,
                                                    hot_slice_add_pallas)
from word2bits_tpu_torch.kernels.scatter_pallas import scatter_add_rmw
from word2bits_tpu_torch.kernels.span_scatter import (
    RowParts, SortPlan, scatter_add_span_planned, sort_plan)
from word2bits_tpu_torch.kernels.sweep_scatter import scatter_add_sweep
from word2bits_tpu_torch.models.cbow import (
    CBOWHyper, ChunkScalars, chunk_slabs, step_alphas)
from word2bits_tpu_torch.models.cbow_slab import (
    SlabInputs, _numpy_to_torch, positive_phase, shared_negative_phase,
    u_update_rows)
from word2bits_tpu_torch.models.step_graph import (StepCounts, StepReplay,
                                                   eager_reason)
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.scatter import (add_rows_where, hot_slice_add,
                                             scatter_add, scatter_add_dedup)
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut
from word2bits_tpu_torch.sampling.unigram import (
    AliasTable, draw_cold, draw_negatives, draw_negatives_stratified)
from word2bits_tpu_torch.utils.trace import span

SCATTER_IMPLS = ("add", "span", "grmw", "sweep")


def interleave(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(V,D),(V,D) -> (V,2D) fused table."""
    return torch.cat([u, v], dim=1)


def deinterleave(table: torch.Tensor):
    D = table.shape[1] // 2
    return table[:, :D], table[:, D:]


def params_from_jax(u, v=None, *, dtype: torch.dtype, device,
                    table_pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """The port's unpadded fused (V, 2D) table from the JAX package's
    parameters, as numpy arrays: either the (V, D) halves `u` and `v`, or
    (v=None) a fused table `u` whose storage carries `table_pad` = (row,
    column) zero padding (the JAX span/rmw layouts), which is trimmed."""
    if v is None:
        vp, cp = table_pad
        t = _numpy_to_torch(u)
        t = t[:t.shape[0] - vp, :t.shape[1] - cp]
    else:
        t = interleave(_numpy_to_torch(u), _numpy_to_torch(v))
    return t.to(device=device, dtype=dtype).contiguous()


def params_to_numpy(table: torch.Tensor) -> np.ndarray:
    """The fused table as a float32 numpy (V, 2D) array (bf16 widens
    exactly); deinterleave gives u and v."""
    return table.detach().to("cpu", torch.float32).numpy()


def scatter_plan(scatter_impl: str, ids: torch.Tensor,
                 table: Optional[torch.Tensor] = None) -> SortPlan:
    """The plan of the `span` or `grmw` scatter for `ids` ([..., N],
    leading dimensions batch steps): kernels 2 and 7 read the same stable
    sort, whatever the route and the table."""
    return sort_plan(ids)


def _dense_hot_phase(table, cavg, af, centers, hot_w, alpha,
                     hyper: CBOWHyper, H: int):
    """The dense hot stratum (the JAX step's `dense_hot` branch): every
    center scores against all H hot words with per-word weight hot_w[h] =
    K * P(draw h), the skip-center quirk an exact (b, h == center) mask.
    Three [B, H] float32 products.  Returns (cavge_hot [B, D], dv_hot
    [H, D], loss)."""
    D, bl, reg = hyper.size, hyper.bitlevel, hyper.reg
    v_h = table[:H, D:].to(torch.float32)                  # a slice
    q_vh = quantize(v_h, bl)
    f_h = cavg @ q_vh.T                                    # [B, H]
    skip = (torch.arange(H, device=table.device)[None, :]
            != centers[:, None])
    mh = skip.to(torch.float32) * af[:, None] * hot_w[None, :]
    g_h = (0.0 - sigmoid_lut(f_h)) * alpha * mh
    hot_reg = (reg * (q_vh * q_vh).sum(dim=-1))[None, :] if reg else 0.0
    loss = ((torch.log(sigmoid_exact(-f_h)) - hot_reg) * mh).sum()
    cavge_hot = g_h @ q_vh                                 # [B, D]
    dv_hot = g_h.T @ cavg                                  # [H, D]
    if reg:
        dv_hot = dv_hot - 2.0 * alpha * reg * v_h * mh.sum(dim=0)[:, None]
    return cavge_hot, dv_hot, loss


def _v_rows(dv: torch.Tensor) -> torch.Tensor:
    """Fused-table rows of v updates: the u half zero."""
    return torch.cat([torch.zeros_like(dv), dv], dim=1)


def fused_slab_step(table: torch.Tensor, inputs: SlabInputs, alpha,
                    hyper: CBOWHyper, batch_size: int, neg_sharing: int,
                    neg_pool: int = 1, banded: int = 0,
                    scatter_impl: str = "add",
                    span_plan: Optional[SortPlan] = None,
                    context_pallas: bool = False, span_chunk: int = 128,
                    use_pallas: bool = False, dedup_block: int = 0,
                    hot_rows: int = 0, cold_pos=None, strat_lanes=None,
                    dense_hot=None, hot_pallas: bool = False,
                    rmw_scatter: bool = False,
                    hot_plan: Optional[HotPlan] = None):
    """One synchronous step on the fused (V, 2D) table, IN PLACE.
    Returns (table, loss) with loss a float32 0-d tensor on the device.
    `span_plan` is the step's hoisted sort_plan for the `span` or `grmw`
    scatter; `span_chunk` is grmw's `chunk`.
    `use_pallas` runs the shared-negative phase through the fused score
    kernel (kernels/score_pallas.py).

    Update routes (module docstring): `rmw_scatter`, `dedup_block`;
    `hot_rows` with `cold_pos` (the step's row of the cold-position map,
    [C] positions in the slab, -1 padded) or without it, `hot_pallas`
    (with `hot_plan`, the step's hoisted kernel plan);
    `strat_lanes` = (kh, w_hot, w_cold) marks inputs.neg_ids as stratified
    draws (per pool of lanes the first kh hot); `dense_hot` = (w_cold,
    hot_w [H]) computes the hot stratum exactly, inputs.neg_ids being the
    cold draws."""
    if not neg_sharing:
        raise ValueError("fused table step requires neg_sharing > 0")
    if scatter_impl not in SCATTER_IMPLS:
        raise ValueError(f"unknown scatter_impl {scatter_impl!r} "
                         f"(supported: {', '.join(SCATTER_IMPLS)})")
    if use_pallas and scatter_impl != "add":
        raise ValueError("use_pallas runs with scatter_impl='add' only")
    if dense_hot is not None and not hot_rows:
        raise ValueError("dense_hot requires hot_rows (the hot-stratum "
                         "boundary of the negative distribution)")
    B, W = batch_size, hyper.window
    D = table.shape[1] // 2
    dt = torch.float32
    dev = table.device
    G = neg_sharing
    if B % G:
        raise ValueError(f"batch {B} not divisible by neg tile {G}")
    T = B // G
    alpha = torch.as_tensor(alpha, dtype=dt, device=dev)

    with span("step.gather"):
        slab_ids = inputs.slab_tokens.clamp_min(0)         # [B+2W]
        centers = slab_ids[W:W + B]
        # ONE gather: u rows for all positions + v rows for the centers
        slab_raw = table[slab_ids]                         # [B+2W, 2D]
    with span("step.positive"):
        pos = positive_phase(slab_raw[:, :D], slab_raw[W:W + B, D:], inputs,
                             alpha, hyper, B, banded, context_pallas)
    with span("step.negative"):
        # shared negatives (strided tiles); v-half gathered from the fused
        # table
        P = neg_pool if neg_pool and neg_pool > 1 else 1
        negs = inputs.neg_ids                              # [T, P*Kl]
        Kl = negs.shape[1] // P            # == K, or kc under dense_hot
        lane_w = None
        if strat_lanes is not None:
            kh, w_hot, w_cold = strat_lanes
            lane_w = torch.where(torch.arange(Kl, device=dev) < kh,
                                 float(w_hot),
                                 float(w_cold)).to(dt).repeat(P)
        elif dense_hot is not None:
            lane_w = torch.full((P * Kl,), dense_hot[0], dtype=dt,
                                device=dev)
        v_n = table[negs][..., D:].to(dt)                  # [T, P*Kl, D]
        cavge_neg, dv_neg, nloss = shared_negative_phase(
            pos.cavg, pos.af, centers, negs, v_n, alpha, hyper, B, G, P,
            use_pallas, lane_weight=lane_w)
        loss = pos.loss + nloss
        cavge = pos.cavge + cavge_neg
        dv_hot = None
        if dense_hot is not None:
            hot_w = torch.as_tensor(dense_hot[1], dtype=dt, device=dev)
            cavge_hot, dv_hot, hloss = _dense_hot_phase(
                table, pos.cavg, pos.af, centers, hot_w, alpha, hyper,
                hot_rows)
            loss = loss + hloss
            cavge = cavge + cavge_hot
    with span("step.rows"):
        du_slab = u_update_rows(pos, cavge, alpha, hyper, B)
        # ONE fused row set [B+2W+T*P*Kl, 2D]: u-positions + center v-rows,
        # then the negative rows (u-half zero), as its three parts
        rows = RowParts(du_slab, pos.dv_center, dv_neg, W)
        neg_ids = negs.reshape(-1)
        if scatter_impl == "add":
            # the slab's rows alone, for the routes that scatter them apart
            dv_slab = torch.zeros((B + 2 * W, D), dtype=dt, device=dev)
            dv_slab[W:W + B] = pos.dv_center
            fused_rows = torch.cat([du_slab, dv_slab], dim=1)  # [B+2W, 2D]
    with span("step.scatter"):
        if scatter_impl == "sweep":
            # one swept call for slab + negative rows, its plan built here
            # as the JAX step builds it; float32 rows round to the table
            # dtype inside the kernel
            scatter_add_sweep(table, torch.cat([slab_ids, neg_ids]),
                              rows.materialize())
            return table, loss
        if scatter_impl in ("span", "grmw"):
            # one sorted call for slab + negative rows
            # (kernels/span_scatter.py, kernels/group_rmw.py), which read
            # the three parts in place on the card; float32 rows round to
            # the table dtype inside the kernels
            plan = span_plan
            if plan is None:
                plan = scatter_plan(scatter_impl,
                                    torch.cat([slab_ids, neg_ids]))
            if scatter_impl == "span":
                scatter_add_span_planned(table, plan, rows)
            else:
                scatter_add_grmw_planned(table, plan, rows,
                                         chunk=span_chunk)
            return table, loss

        if rmw_scatter:
            # kernel 8 rounds the float32 rows to the table dtype in
            # registers
            def scat(ids, rows):
                scatter_add_rmw(table, ids, rows)
        elif dedup_block:
            def scat(ids, rows):
                scatter_add_dedup(table, ids, rows.to(table.dtype),
                                  dedup_block)
        else:
            def scat(ids, rows):
                scatter_add(table, ids, rows)

        if not hot_rows:
            scat(slab_ids, fused_rows)
            scat(neg_ids, _v_rows(dv_neg))
            return table, loss

        # the hot/cold split: ids < hot_rows (the vocabulary is
        # count-sorted) accumulate densely into the head table[:hot_rows]
        hot_ids, hot_mat = slab_ids, fused_rows
        if strat_lanes is not None:
            # stratified lanes: the first kh of each pool are hot by
            # construction and join the head accumulation
            negs4 = negs.reshape(T, P, Kl)
            dv4 = dv_neg.reshape(T, P, Kl, D)
            hot_ids = torch.cat([slab_ids, negs4[:, :, :kh].reshape(-1)])
            hot_mat = torch.cat([fused_rows,
                                 _v_rows(dv4[:, :, :kh].reshape(-1, D))])
        extra = None if dv_hot is None else _v_rows(dv_hot)  # [H, 2D]
        if cold_pos is None:
            # no cold-position map: the plain slab scatter, plus only the
            # dense-hot head delta
            if strat_lanes is not None:
                raise ValueError("strat_lanes requires cold_pos (it exists "
                                 "only for the hot/cold scatter split)")
            if extra is not None:
                table[:hot_rows] = (table[:hot_rows].to(dt)
                                    + extra).to(table.dtype)
            scat(slab_ids, fused_rows)
        else:
            if hot_pallas:
                hot_slice_add_pallas(table, hot_ids, hot_mat, hot_rows,
                                     extra=extra, plan=hot_plan)
            else:
                hot_slice_add(table, hot_ids, hot_mat, hot_rows, extra=extra)
            # the cold rows, compacted by the epoch's precomputed positions
            ok = cold_pos >= 0
            posc = cold_pos.clamp_min(0)
            add_rows_where(table, slab_ids[posc], fused_rows[posc], ok)
        if strat_lanes is not None:
            if Kl - kh:   # cold lanes: compact by construction
                scatter_add(table, negs4[:, :, kh:].reshape(-1),
                            _v_rows(dv4[:, :, kh:].reshape(-1, D)))
            return table, loss
        if dense_hot is not None:
            # the sampled lanes are all cold (ids >= hot_rows)
            scatter_add(table, neg_ids, _v_rows(dv_neg))
            return table, loss
        scat(neg_ids, _v_rows(dv_neg))
        return table, loss


def make_fused_train_chunk(hyper: CBOWHyper, vocab_size: int,
                           batch_size: int, steps: int, neg_sharing: int,
                           neg_pool: int = 1, banded: int = 0,
                           scatter_impl: str = "add",
                           context_pallas: bool = False,
                           span_chunk: int = 128,
                           use_pallas: bool = False, dedup_block: int = 0,
                           hot_rows: int = 0, strat_lanes=None,
                           dense_hot=None, hot_pallas: bool = False,
                           rmw_scatter: bool = False):
    """chunk(table, tokens, sent_ids, atab, scalars, gen, n_steps=None,
    shrinks=None, negs=None, cold_pos=None) -> (table, loss_sum).

    Runs n_steps (default `steps`) synchronous steps on the fused table IN
    PLACE.  tokens/sent_ids are the epoch arrays on the table's device;
    step s takes centers at base0 + s*B.  The LR decays linearly per step
    with the reference's 1e-4*alpha0 floor (reference :391-392), in
    float32.  The window shrinks [S, B] and negatives [S, B/G, P*K] of all
    steps are drawn from `gen` at chunk entry unless injected; with the
    span or grmw scatter the sort plan of all steps is built once here.

    With hot_rows > 0, `cold_pos` is the segment's cold-position map
    (data/pipeline.cold_positions, [n_rows, C]; global step t = (base0 -
    W)//B + s takes row t) for the hot/cold split; without it the slab
    keeps the plain scatter and hot_rows only bounds the negative strata.
    With strat_lanes = (kh, w_hot, w_cold) (StratifiedSampler.lane_split)
    `atab` is the (hot, cold) pair of alias tables; with dense_hot = (kc,
    w_cold, hot_w [H]) (StratifiedSampler.dense_split) it is the cold
    stratum's table and kc cold lanes are drawn per pool.

    On a CUDA table the routes that models/step_graph.eager_reason passes
    (the span and grmw scatters) replay their step from a CUDA graph,
    captured at the first step of a new key, with the same results bit for
    bit; `chunk.counts` (StepCounts) counts the steps replayed and run
    eagerly."""
    if scatter_impl not in SCATTER_IMPLS:
        raise ValueError(f"unknown scatter_impl {scatter_impl!r} "
                         f"(supported: {', '.join(SCATTER_IMPLS)})")
    if use_pallas and scatter_impl != "add":
        raise ValueError("use_pallas runs with scatter_impl='add' only")
    hot_rows = min(int(hot_rows), vocab_size)
    restructured = (dedup_block or hot_rows or strat_lanes is not None
                    or dense_hot is not None)
    if rmw_scatter and (use_pallas or restructured):
        raise ValueError(
            "rmw_scatter is the plain-scatter capacity path; it does not "
            "compose with use_pallas/dedup_block/hot_rows/strat_lanes/"
            "dense_hot (those restructure the scatter themselves)")
    if scatter_impl != "add" and (rmw_scatter or restructured):
        raise ValueError("scatter_impl='span'/'grmw'/'sweep' replaces the "
                         "plain scatter; it does not compose with rmw_scatter/"
                         "dedup_block/hot_rows/strat_lanes/dense_hot")
    if (strat_lanes is not None or dense_hot is not None) and not hot_rows:
        raise ValueError("strat_lanes/dense_hot require hot_rows")
    B, W, K = batch_size, hyper.window, hyper.negative
    P = neg_pool if (neg_pool and neg_pool > 1) else 1
    if not neg_sharing or B % neg_sharing:
        raise ValueError(f"neg_sharing ({neg_sharing}) must be > 0 and "
                         f"divide batch_size ({B})")
    T = B // neg_sharing
    counts = StepCounts()
    replay = None
    if eager_reason(scatter_impl, use_pallas=use_pallas,
                    rmw_scatter=rmw_scatter, dedup_block=dedup_block,
                    hot_rows=hot_rows) is None:
        replay = StepReplay(counts)

    def chunk(table: torch.Tensor, tokens: torch.Tensor,
              sent_ids: torch.Tensor,
              atab: AliasTable | Tuple[AliasTable, AliasTable],
              scalars: ChunkScalars,
              gen: Optional[torch.Generator] = None,
              n_steps: Optional[int] = None,
              shrinks: Optional[torch.Tensor] = None,
              negs: Optional[torch.Tensor] = None,
              cold_pos: Optional[torch.Tensor] = None):
        dev = table.device
        S = steps if n_steps is None else n_steps
        with span("chunk.draws"):
            slab_tokens, slab_sents = chunk_slabs(tokens, sent_ids,
                                                  scalars.base0, S, B, W)
            if shrinks is None:
                shrinks = torch.randint(0, W, (S, B), generator=gen,
                                        device=dev)
            if negs is None:
                if strat_lanes is not None:
                    hot_t, cold_t = atab
                    negs = draw_negatives_stratified(
                        gen, hot_t, cold_t, (S, T), P, K, strat_lanes[0],
                        hot_rows)
                elif dense_hot is not None:
                    negs = draw_cold(gen, atab, (S, T, P * dense_hot[0]),
                                     hot_rows)
                else:
                    negs = draw_negatives(gen, atab, (S, T, P * K),
                                          vocab_size)
            step_dense = None
            if dense_hot is not None:
                step_dense = (dense_hot[1], torch.as_tensor(
                    dense_hot[2], dtype=torch.float32, device=dev))
            alphas = step_alphas(scalars, S, dev)
        with span("chunk.plan"):
            plans = None
            if scatter_impl in ("span", "grmw"):
                # hoisted: every step's scatter ids are known at chunk entry
                ids_all = torch.cat([slab_tokens.clamp_min(0),
                                     negs.reshape(S, -1)], dim=1)
                plans = scatter_plan(scatter_impl, ids_all)
            hot_plans = None
            if hot_pallas and cold_pos is not None:
                # hoisted: the rows of the head accumulation are the slab's
                # and, stratified, each pool's first kh lanes
                hot_ids = slab_tokens.clamp_min(0)
                if strat_lanes is not None:
                    lanes = negs.reshape(S, T, P, K)[..., :strat_lanes[0]]
                    hot_ids = torch.cat([hot_ids, lanes.reshape(S, -1)],
                                        dim=1)
                hot_plans = hot_plan(hot_ids, hot_rows)
        if replay is not None and dev.type == "cuda":
            def step_inputs(s):
                return (SlabInputs(slab_tokens=slab_tokens[s],
                                   slab_sents=slab_sents[s],
                                   shrink=shrinks[s], neg_ids=negs[s]),
                        alphas[s], plans.step(s))

            def step(inputs, alpha, plan):
                return fused_slab_step(
                    table, inputs, alpha, hyper, B, neg_sharing, neg_pool=P,
                    banded=banded, scatter_impl=scatter_impl, span_plan=plan,
                    context_pallas=context_pallas, span_chunk=span_chunk)[1]

            return table, replay.run(table, S, step_inputs, step)
        t0 = (scalars.base0 - W) // B
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(S):
            inputs = SlabInputs(slab_tokens=slab_tokens[s],
                                slab_sents=slab_sents[s],
                                shrink=shrinks[s], neg_ids=negs[s])
            cp = None
            if hot_rows and cold_pos is not None:
                cp = cold_pos[min(max(t0 + s, 0), cold_pos.shape[0] - 1)]
            with span("step"):
                table, step_loss = fused_slab_step(
                    table, inputs, alphas[s], hyper, B, neg_sharing,
                    neg_pool=P, banded=banded, scatter_impl=scatter_impl,
                    span_plan=None if plans is None else plans.step(s),
                    context_pallas=context_pallas, span_chunk=span_chunk,
                    use_pallas=use_pallas, dedup_block=dedup_block,
                    hot_rows=hot_rows, cold_pos=cp, strat_lanes=strat_lanes,
                    dense_hot=step_dense, hot_pallas=hot_pallas,
                    rmw_scatter=rmw_scatter,
                    hot_plan=None if hot_plans is None else hot_plans.step(s))
                loss = loss + step_loss
        counts.eager += S
        return table, loss

    chunk.counts = counts
    return chunk
