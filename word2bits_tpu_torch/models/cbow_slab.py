"""Slab-formulation CBOW step on split (u, v) tables: the reference-default
engine (per-center negatives, `-neg-sharing 0`).

The counterpart of the JAX package's models/cbow_slab.py.  A batch of B
*consecutive* centers reuses the same B+2W corpus positions as contexts,
so one slab gather serves every context row, the context averages are
masked shifted sums (or banded products, `banded > 0`), and the u updates
group by slab position into one scatter of B+2W rows.  Negatives are drawn
per center ([B, K], the reference's semantics) or shared across strided
tiles of G centers (center b joins tile b % T) with P pools per tile
(center g uses pool g % P).  Same update as `models/cbow.
cbow_minibatch_update` modulo float order (tested equal).

Every branch the configuration reaches is here: per-center and shared
negatives; shifted-sum and banded windows; reg = 0 and > 0; the `add`
(ops/scatter.scatter_add) and `span` (sorted kernel, csrc/span_scatter.cu,
with the plan hoisted to the chunk) scatters on
u and v, and the JAX package's whole `scat` switch besides (the block
dedup, `dedup_block`, ops/scatter.py; the hot/cold split `scatter_add_hot`,
`hot_rows`, reachable through this API only: the configuration asks for
fused tables with -hot-rows); the fused context kernel on split tables
(`context_pallas`); the banded u-sum kernel on every banded step of a card
(kernels/band_usum.py); the fused score kernel (`use_pallas`, csrc/score.cu);
and the rank-1 span scatter of the per-center v update (`span_rank1`).
The tables are stored unpadded and updated IN PLACE; `params_from_jax`
trims the JAX package's span padding.  The fused-table step
(models/cbow_fused.py) shares the context, positive and u-sum code below.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from word2bits_tpu_torch.kernels.band_usum import band_usum
from word2bits_tpu_torch.kernels.context_pallas import fused_context_rows
from word2bits_tpu_torch.kernels.score_pallas import (  # noqa: F401
    pool_mask, quantized_scores_pallas, quantized_scores_plain)
from word2bits_tpu_torch.kernels.span_scatter import (
    SortPlan, scatter_add_span_planned, scatter_add_span_rank1, sort_plan)
from word2bits_tpu_torch.models.cbow import (
    CBOWHyper, ChunkScalars, chunk_slabs, step_alphas)
from word2bits_tpu_torch.ops.consts import const
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.scatter import (add_rows_where, hot_slice_add,
                                             scatter_add, scatter_add_dedup)
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut
from word2bits_tpu_torch.ops.windowed import (
    banded_context, build_banded_masks, pick_tile)
from word2bits_tpu_torch.sampling.unigram import AliasTable, draw_negatives
from word2bits_tpu_torch.utils.trace import span

SLAB_SCATTER_IMPLS = ("add", "span")


class SlabInputs(NamedTuple):
    """Deterministic per-step inputs (randomness drawn by the chunk, or
    injected by a test)."""

    slab_tokens: torch.Tensor   # int [B+2W] — corpus ids, -1 padding
    slab_sents: torch.Tensor    # int [B+2W] — sentence ids, -1 padding
    shrink: torch.Tensor        # int [B] — window shrink b in [0, W)
    neg_ids: torch.Tensor       # int [B, K] per-center, [B//G, P*K] shared


def to_tiles(x: torch.Tensor, T: int, G: int) -> torch.Tensor:
    """[B, ...] -> [T, G, ...], STRIDED: tile t holds centers t, t+T, t+2T…"""
    return x.reshape((G, T) + tuple(x.shape[1:])).transpose(0, 1)


def from_tiles(x: torch.Tensor, B: int) -> torch.Tensor:
    """Inverse of to_tiles."""
    return x.transpose(0, 1).reshape((B,) + tuple(x.shape[2:]))


def _context_masks(inputs: SlabInputs, B: int, W: int):
    """(offsets, mask [B, 2W] bool, valid [B]) for the offsets -W..-1,
    1..W: in the shrunk window, same sentence, both unpadded."""
    sents = inputs.slab_sents
    csent = sents[W:W + B]
    valid = csent >= 0
    offsets = [o for o in range(-W, W + 1) if o != 0]
    odist = const(tuple(abs(o) for o in offsets), torch.int64, sents.device)
    in_win = odist[None, :] <= (W - inputs.shrink)[:, None]
    ctx_sent = torch.stack([sents[W + o:W + o + B] for o in offsets], dim=1)
    mask = (in_win & (ctx_sent == csent[:, None]) & valid[:, None]
            & (ctx_sent >= 0))
    return offsets, mask, valid


class Positive(NamedTuple):
    """The context and positive phase of a slab step."""

    cavg: torch.Tensor        # [B, D] f32 context averages
    cavge: torch.Tensor       # [B, D] f32 u-gradient accumulator seed
    dv_center: torch.Tensor   # [B, D] f32 center v update rows
    af: torch.Tensor          # [B] f32 active centers
    loss: torch.Tensor        # [] f32
    u_slab: Optional[torch.Tensor]  # [B+2W, D] f32 (None with the kernel)
    windows: tuple            # ("banded", Mb) or ("shifted", mf, offsets)


def positive_phase(u_rows: torch.Tensor, vc_rows: torch.Tensor,
                   inputs: SlabInputs, alpha: torch.Tensor, hyper: CBOWHyper,
                   B: int, banded: int, context_pallas: bool,
                   slab_ids: Optional[torch.Tensor] = None) -> Positive:
    """Context averages and the center (positive) term from the slab's u
    rows [B+2W, D] and the centers' v rows [B, D], both in the table
    dtype; or, given `slab_ids` [B+2W], from the tables u_rows and vc_rows
    ([V, D] each) that hold them: slab row p is u_rows[slab_ids[p]], center
    b's v row vc_rows[slab_ids[W + b]].  `context_pallas` runs the fused
    context kernel (kernels/context_pallas.py; banded > 0, reg == 0), which
    reads the rows from the tables by id and so needs `slab_ids`."""
    W, D = hyper.window, hyper.size
    bl, reg = hyper.bitlevel, hyper.reg
    dt = torch.float32
    if banded:
        btile = pick_tile(B, W, banded)
        Mb, _, valid = build_banded_masks(inputs.slab_sents, inputs.shrink,
                                          B, W, btile)
        windows = ("banded", Mb)
    elif context_pallas:
        raise ValueError("context_pallas requires banded > 0 (the kernel "
                         "consumes the banded masks)")
    if context_pallas:
        if reg:
            raise ValueError("context_pallas supports reg == 0 only")
        if slab_ids is None:
            raise ValueError("context_pallas reads the rows from their "
                             "tables by id: pass slab_ids")
        cavg, cavge, dv_center, af, loss = fused_context_rows(
            u_rows, vc_rows, slab_ids, Mb, valid.to(dt)[:, None],
            alpha.reshape(1, 1), bl)
        return Positive(cavg, cavge, dv_center, af, loss, None, windows)
    if slab_ids is not None:
        u_rows, vc_rows = u_rows[slab_ids], vc_rows[slab_ids[W:W + B]]
    u_slab = u_rows.to(dt)
    q_slab = quantize(u_slab, bl)
    q_sq = (q_slab * q_slab).sum(dim=-1) if reg else None
    if banded:
        csum, sq_sum, cw = banded_context(q_slab, q_sq, Mb, B)
    else:
        offsets, mask, valid = _context_masks(inputs, B, W)
        mf = mask.to(dt)
        windows = ("shifted", mf, offsets)
        csum = torch.zeros((B, D), dtype=dt, device=u_rows.device)
        sq_sum = torch.zeros((B,), dtype=dt, device=u_rows.device)
        for oi, o in enumerate(offsets):
            csum = csum + mf[:, oi, None] * q_slab[W + o:W + o + B]
            if reg:
                sq_sum = sq_sum + mf[:, oi] * q_sq[W + o:W + o + B]
        cw = mf.sum(dim=1)
    af = (valid & (cw > 0)).to(dt)
    cavg = csum / torch.clamp_min(cw, 1.0)[:, None]
    loss = ((-reg * (sq_sum * af).sum()) if reg
            else torch.zeros((), dtype=dt, device=u_rows.device))
    v_c = vc_rows.to(dt)
    q_vc = quantize(v_c, bl)
    f_pos = (cavg * q_vc).sum(dim=-1)
    g_pos = (1.0 - sigmoid_lut(f_pos)) * alpha * af
    pos_reg = (reg * (q_vc * q_vc).sum(dim=-1)) if reg else 0.0
    loss = loss + ((torch.log(sigmoid_exact(f_pos)) - pos_reg) * af).sum()
    cavge = g_pos[:, None] * q_vc
    dv_center = g_pos[:, None] * cavg
    if reg:
        dv_center = dv_center - 2.0 * alpha * reg * v_c * af[:, None]
    return Positive(cavg, cavge, dv_center, af, loss, u_slab, windows)


def u_update_rows(pos: Positive, cavge: torch.Tensor, alpha: torch.Tensor,
                  hyper: CBOWHyper, B: int) -> torch.Tensor:
    """[B+2W, D] f32 u update of each slab position: the windowed sum of
    the active centers' cavge, minus the per-visit decay at reg > 0."""
    W = hyper.window
    if pos.windows[0] == "banded":
        du_slab, cnt = band_usum(pos.windows[1], pos.af, cavge, W,
                                 with_cnt=bool(hyper.reg))
    else:
        _, mf, offsets = pos.windows
        mc = mf * pos.af[:, None]
        du_slab = torch.zeros((B + 2 * W, cavge.shape[1]), dtype=cavge.dtype,
                              device=cavge.device)
        cnt = torch.zeros((B + 2 * W,), dtype=cavge.dtype,
                          device=cavge.device)
        for oi, o in enumerate(offsets):
            du_slab[W + o:W + o + B] += mc[:, oi, None] * cavge
            cnt[W + o:W + o + B] += mc[:, oi]
    if hyper.reg:
        du_slab = du_slab - 2.0 * alpha * hyper.reg * pos.u_slab * cnt[:, None]
    return du_slab


def shared_negative_phase(cavg, af, centers, negs, v_n, alpha,
                          hyper: CBOWHyper, B: int, G: int, P: int,
                          use_pallas: bool, lane_weight=None,
                          pool_offset: int = 0):
    """(cavge_neg [B, D], dv_neg [T*P*K, D], loss) of the negatives shared
    by strided tiles of G centers: the fused score kernel
    (kernels/score_pallas.py) with `use_pallas`, else its plain version,
    whose mask `lane_weight` ([P*K], optional) scales per lane and whose
    pool routing starts at member `pool_offset` (a mesh's data shard)."""
    if use_pallas and (lane_weight is not None or pool_offset):
        raise ValueError("the score kernel takes no lane weights and no "
                         "pool offset (the stratified and dense-hot "
                         "samplers and the mesh exclude use_pallas)")
    T = B // G
    args = [to_tiles(cavg, T, G), v_n, to_tiles(centers, T, G), negs,
            to_tiles(af, T, G)]
    if use_pallas:
        # the kernel reads dense rows; the fused table's v_n is a strided
        # view of its columns
        args = [a.contiguous() for a in args]
    args += [alpha.reshape(1, 1), hyper.bitlevel, float(hyper.reg), P]
    if use_pallas:
        cavge_neg, dv_neg, nloss = quantized_scores_pallas(*args)
    else:
        cavge_neg, dv_neg, nloss = quantized_scores_plain(
            *args, lane_weight=lane_weight, pool_offset=pool_offset)
    return from_tiles(cavge_neg, B), dv_neg.reshape(-1, hyper.size), nloss


def per_center_negative_phase(cavg, af, centers, negs, v_n, alpha,
                              hyper: CBOWHyper, weight=None):
    """(g_neg [B, K], mask [B, K], cavge_neg [B, D], loss) of per-center
    negatives negs [B, K] with float32 rows v_n [B, K, D]; `weight`
    (optional) scales the mask (the dense-hot sampler's cold weight)."""
    q_vn = quantize(v_n, hyper.bitlevel)
    f_neg = torch.bmm(q_vn, cavg[:, :, None])[..., 0]            # [B, K]
    m2 = (negs != centers[:, None]).to(torch.float32) * af[:, None]
    if weight is not None:
        m2 = m2 * weight
    g_neg = (0.0 - sigmoid_lut(f_neg)) * alpha * m2
    reg = hyper.reg
    neg_reg = (reg * (q_vn * q_vn).sum(dim=-1)) if reg else 0.0
    loss = ((torch.log(sigmoid_exact(-f_neg)) - neg_reg) * m2).sum()
    return g_neg, m2, torch.bmm(g_neg[:, None, :], q_vn)[:, 0], loss


def scatter_add_hot(table: torch.Tensor, ids: torch.Tensor,
                    rows: torch.Tensor, hot_rows: int) -> torch.Tensor:
    """table[ids] += rows in place, the rows of the `hot_rows` most
    frequent words (ids < hot_rows: the vocabulary is count-sorted) summed
    in float32 into the head with one rounding, the rest added one by one
    as the plain scatter does; the rows are first rounded to the table
    dtype.  The JAX package's scatter_add_hot (a one-hot product there)."""
    rows = rows.to(table.dtype)
    if hot_rows <= 0:
        return scatter_add(table, ids, rows)
    hot_slice_add(table, ids, rows, hot_rows)
    return add_rows_where(table, ids, rows, ids >= hot_rows)


def _check_slab_options(hot_rows: int, dedup_block: int,
                        scatter_impl: str) -> None:
    if scatter_impl not in SLAB_SCATTER_IMPLS:
        raise ValueError(f"unknown scatter_impl {scatter_impl!r} (slab path "
                         f"supports {', '.join(SLAB_SCATTER_IMPLS)})")
    if scatter_impl == "span" and (hot_rows or dedup_block):
        raise ValueError("scatter_impl='span' replaces the plain scatter; "
                         "it does not compose with hot_rows/dedup_block")


def slab_step(u: torch.Tensor, v: torch.Tensor, inputs: SlabInputs, alpha,
              hyper: CBOWHyper, batch_size: int, neg_sharing: int = 0,
              use_pallas: bool = False, hot_rows: int = 0,
              dedup_block: int = 0, neg_pool: int = 1, banded: int = 0,
              scatter_impl: str = "add",
              span_plans: Optional[Tuple[SortPlan, SortPlan]] = None,
              span_rank1: bool = False, context_pallas: bool = False):
    """One synchronous step over B consecutive centers on u and v IN PLACE.
    Returns (u, v, loss) with loss a float32 0-d tensor on the device.

    span_plans = (plan of the slab ids, plan of [centers; negatives]) is
    the step's hoisted pair of sort plans.  `span_rank1` (span, reg == 0,
    per-center) forms the negative v rows inside the scatter kernel."""
    _check_slab_options(hot_rows, dedup_block, scatter_impl)
    if use_pallas and not neg_sharing:
        raise ValueError("use_pallas requires neg_sharing > 0")
    B, W, K, D = batch_size, hyper.window, hyper.negative, hyper.size
    reg = hyper.reg
    spanning = scatter_impl == "span"
    dev = u.device
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)

    def scat(tab, ids, rows, plan):
        if spanning:
            if plan is None:
                plan = sort_plan(ids)
            scatter_add_span_planned(tab, plan, rows)
        elif dedup_block:
            scatter_add_dedup(tab, ids, rows.to(tab.dtype), dedup_block)
        else:
            scatter_add_hot(tab, ids, rows, hot_rows)

    slab_ids = inputs.slab_tokens.clamp_min(0)                 # [B+2W]
    centers = slab_ids[W:W + B]
    pos = positive_phase(u, v, inputs, alpha, hyper, B, banded,
                         context_pallas, slab_ids=slab_ids)
    loss = pos.loss
    negs = inputs.neg_ids
    ids_v = torch.cat([centers, negs.reshape(-1)])
    plan_u, plan_v = span_plans if span_plans is not None else (None, None)
    v_n = v[negs].to(torch.float32)             # [T, P*K, D] or [B, K, D]
    if neg_sharing:
        G = neg_sharing
        if B % G:
            raise ValueError(f"batch {B} not divisible by neg tile {G}")
        P = neg_pool if neg_pool and neg_pool > 1 else 1
        cavge_neg, dv_neg, nloss = shared_negative_phase(
            pos.cavg, pos.af, centers, negs, v_n, alpha, hyper, B, G, P,
            use_pallas)
        loss = loss + nloss
        cavge = pos.cavge + cavge_neg
        scat(v, ids_v, torch.cat([pos.dv_center, dv_neg]), plan_v)
    else:
        g_neg, m2, cavge_neg, nloss = per_center_negative_phase(
            pos.cavg, pos.af, centers, negs, v_n, alpha, hyper)
        loss = loss + nloss
        cavge = pos.cavge + cavge_neg
        if spanning and reg == 0.0 and span_rank1:
            # rows centers: dv_center; negative (b, k): g_neg[b, k]*cavg[b]
            if plan_v is None:
                plan_v = sort_plan(ids_v)
            scatter_add_span_rank1(v, plan_v, pos.dv_center,
                                   g_neg.reshape(-1).contiguous(), pos.cavg,
                                   K)
        else:
            dv_neg = g_neg[..., None] * pos.cavg[:, None, :]
            if reg:
                dv_neg = dv_neg - 2.0 * alpha * reg * v_n * m2[..., None]
            scat(v, ids_v, torch.cat([pos.dv_center, dv_neg.reshape(-1, D)]),
                 plan_v)
    scat(u, slab_ids, u_update_rows(pos, cavge, alpha, hyper, B), plan_u)
    return u, v, loss


def make_slab_train_chunk(hyper: CBOWHyper, vocab_size: int, batch_size: int,
                          steps: int, neg_sharing: int = 0,
                          use_pallas: bool = False, hot_rows: int = 0,
                          dedup_block: int = 0, neg_pool: int = 1,
                          banded: int = 0, scatter_impl: str = "add",
                          span_rank1: bool = False,
                          context_pallas: bool = False):
    """chunk(u, v, tokens, sent_ids, atab, scalars, gen=None, n_steps=None,
    shrinks=None, negs=None) -> (u, v, loss_sum).

    Runs n_steps (default `steps`) slab steps on u and v IN PLACE; step s
    takes centers at base0 + s*B.  The window shrinks [S, B] and negatives
    ([S, B, K] per-center, [S, B/G, P*K] shared) of all steps are drawn
    from `gen` at chunk entry unless injected; with the span scatter both
    sort plans of every step (u on the slab ids, v on [centers;
    negatives]) are built once here."""
    _check_slab_options(hot_rows, dedup_block, scatter_impl)
    B, W, K = batch_size, hyper.window, hyper.negative
    if neg_sharing and B % neg_sharing:
        raise ValueError(f"neg_sharing ({neg_sharing}) must divide "
                         f"batch_size ({B})")
    P = neg_pool if (neg_sharing and neg_pool and neg_pool > 1) else 1
    neg_shape = (B // neg_sharing, P * K) if neg_sharing else (B, K)

    def chunk(u: torch.Tensor, v: torch.Tensor, tokens: torch.Tensor,
              sent_ids: torch.Tensor, atab: AliasTable,
              scalars: ChunkScalars, gen: Optional[torch.Generator] = None,
              n_steps: Optional[int] = None,
              shrinks: Optional[torch.Tensor] = None,
              negs: Optional[torch.Tensor] = None):
        dev = u.device
        S = steps if n_steps is None else n_steps
        slab_tokens, slab_sents = chunk_slabs(tokens, sent_ids,
                                              scalars.base0, S, B, W)
        if shrinks is None:
            shrinks = torch.randint(0, W, (S, B), generator=gen, device=dev)
        if negs is None:
            negs = draw_negatives(gen, atab, (S,) + neg_shape, vocab_size)
        alphas = step_alphas(scalars, S, dev)
        plans_u = plans_v = None
        if scatter_impl == "span":
            # hoisted: every step's scatter ids are known at chunk entry
            slab_ids = slab_tokens.clamp_min(0)
            plans_u = sort_plan(slab_ids)
            plans_v = sort_plan(torch.cat([slab_ids[:, W:W + B],
                                           negs.reshape(S, -1)], dim=1))
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(S):
            inputs = SlabInputs(slab_tokens=slab_tokens[s],
                                slab_sents=slab_sents[s],
                                shrink=shrinks[s], neg_ids=negs[s])
            plans = (None if plans_u is None
                     else (plans_u.step(s), plans_v.step(s)))
            with span("step"):
                u, v, step_loss = slab_step(
                    u, v, inputs, alphas[s], hyper, B, neg_sharing,
                    use_pallas=use_pallas, hot_rows=hot_rows,
                    dedup_block=dedup_block, neg_pool=P, banded=banded,
                    scatter_impl=scatter_impl, span_plans=plans,
                    span_rank1=span_rank1, context_pallas=context_pallas)
                loss = loss + step_loss
        return u, v, loss

    return chunk


def _numpy_to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; JAX's bf16 arrays (ml_dtypes.bfloat16, which
    torch.from_numpy refuses) go through their 16-bit pattern."""
    a = np.array(a, copy=True)  # writable: JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(u, v, *, dtype: torch.dtype, device,
                    table_pad: Tuple[int, int] = (0, 0)):
    """The port's unpadded split tables (u, v) from the JAX package's, as
    numpy arrays whose storage carries `table_pad` = (row, column) zero
    padding (the JAX span layout: rows to the sweep window, columns to the
    128-lane tile), which is trimmed."""
    vp, cp = table_pad

    def trim(a):
        t = _numpy_to_torch(a)
        t = t[:t.shape[0] - vp, :t.shape[1] - cp]
        return t.to(device=device, dtype=dtype).contiguous()

    return trim(u), trim(v)
