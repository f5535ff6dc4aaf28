"""Interleaved-table CBOW step: u and v fused into one (V, 2D) table.

table[:, :D] = u and table[:, D:] = v, so the u rows updated by slab
position and the v rows updated for the centers carry the same word ids and
go out in ONE scatter of B+2W double-width rows; the center v rows ride the
slab gather.  Semantics are those of the JAX package's
models/cbow_fused.py, restricted to what the ported configurations run:
shared negatives (neg_sharing > 0) with pools, the banded windowed sums
with or without the fused context kernel, and the `add` (index_add_),
`span` (sorted kernel, the shipped throughput configuration) or `grmw`
(sorted group-RMW kernel, the 3.7M x 800d capacity configuration) scatter.

PyTorch idiom: the table is updated IN PLACE (JAX donates it), the S steps
of a chunk are a Python loop, and the chunk's randomness comes from an
explicit torch.Generator — drawn at chunk entry for all S steps, or
injected by the caller.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from word2bits_tpu_torch.kernels.context_pallas import fused_context_pallas
from word2bits_tpu_torch.kernels.group_rmw import (
    GroupPlan, group_plan, group_rows, scatter_add_grmw_planned)
from word2bits_tpu_torch.kernels.span_scatter import (
    SpanPlan, scatter_add_span_planned, span_plan)
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.models.cbow_slab import (
    SlabInputs, from_tiles, pool_mask, to_tiles)
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut
from word2bits_tpu_torch.ops.windowed import (
    _tile_windows, banded_context, banded_usum, build_banded_masks, pick_tile)
from word2bits_tpu_torch.sampling.unigram import AliasTable, draw_negatives

SCATTER_IMPLS = ("add", "span", "grmw")
LOOP_MODES = ("scan", "fori", "unroll")


def interleave(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(V,D),(V,D) -> (V,2D) fused table."""
    return torch.cat([u, v], dim=1)


def deinterleave(table: torch.Tensor):
    D = table.shape[1] // 2
    return table[:, :D], table[:, D:]


def _numpy_to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; JAX's bf16 arrays (ml_dtypes.bfloat16, which
    torch.from_numpy refuses) go through their 16-bit pattern."""
    a = np.array(a, copy=True)  # writable: JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


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


def scatter_plan(scatter_impl: str, ids: torch.Tensor, table: torch.Tensor,
                 span_chunk: int = 128):
    """The sort plan of the `span` or `grmw` scatter for `ids` ([..., N],
    leading dimensions batch steps) into `table`."""
    if scatter_impl == "span":
        return span_plan(ids, table.shape[0])
    return group_plan(ids, group_rows(table.dtype), chunk=span_chunk)


def fused_slab_step(table: torch.Tensor, inputs: SlabInputs, alpha,
                    hyper: CBOWHyper, batch_size: int, neg_sharing: int,
                    neg_pool: int = 1, banded: int = 0,
                    scatter_impl: str = "add",
                    span_plan: Optional[SpanPlan | GroupPlan] = None,
                    context_pallas: bool = False, span_chunk: int = 128):
    """One synchronous step on the fused (V, 2D) table, IN PLACE.
    Returns (table, loss) with loss a float32 0-d tensor on the device.
    `span_plan` is the step's hoisted plan for the `span` (SpanPlan) or
    `grmw` (GroupPlan) scatter; `span_chunk` is grmw's `chunk`."""
    if not neg_sharing:
        raise ValueError("fused table step requires neg_sharing > 0")
    if not banded:
        raise ValueError("the fused step runs the banded windowed sums "
                         "only: pass banded > 0 (-banded-tile)")
    if scatter_impl not in SCATTER_IMPLS:
        raise ValueError(f"unknown scatter_impl {scatter_impl!r} "
                         f"(supported: {', '.join(SCATTER_IMPLS)})")
    B, W = batch_size, hyper.window
    D = table.shape[1] // 2
    bl, reg = hyper.bitlevel, hyper.reg
    dt = torch.float32
    dev = table.device
    G = neg_sharing
    if B % G:
        raise ValueError(f"batch {B} not divisible by neg tile {G}")
    T = B // G
    alpha = torch.as_tensor(alpha, dtype=dt, device=dev)

    slab_ids = inputs.slab_tokens.clamp_min(0)             # [B+2W]
    centers = slab_ids[W:W + B]
    # ONE gather: u rows for all positions + v rows for the centers
    slab_raw = table[slab_ids]                             # [B+2W, 2D]
    two_ar = 2.0 * alpha * reg
    btile = pick_tile(B, W, banded)
    Nt = B // btile
    Mb, _, valid = build_banded_masks(inputs.slab_sents, inputs.shrink, B,
                                      W, btile)
    if context_pallas:
        # fused context + positive forward (kernels/context_pallas.py)
        if reg:
            raise ValueError("context_pallas supports reg == 0 only")
        uwin3 = _tile_windows(slab_raw[:, :D], Nt, btile, W).contiguous()
        cavg, cavge, dv_center, af, loss = fused_context_pallas(
            uwin3, slab_raw[W:W + B, D:].contiguous(), Mb,
            valid.to(dt)[:, None], alpha.reshape(1, 1), bl)
        u_slab = None   # unused at reg == 0
    else:
        slab_rows = slab_raw.to(dt)
        u_slab = slab_rows[:, :D]
        v_c = slab_rows[W:W + B, D:]                       # centers' v rows
        q_slab = quantize(u_slab, bl)
        q_sq = (q_slab * q_slab).sum(dim=-1) if reg else None
        csum, sq_sum, cw = banded_context(q_slab, q_sq, Mb, B)
        af = (valid & (cw > 0)).to(dt)
        cavg = csum / torch.clamp_min(cw, 1.0)[:, None]
        loss = (-reg * (sq_sum * af).sum()) if reg else torch.zeros(
            (), dtype=dt, device=dev)
        q_vc = quantize(v_c, bl)
        f_pos = (cavg * q_vc).sum(dim=-1)
        g_pos = (1.0 - sigmoid_lut(f_pos)) * alpha * af
        pos_reg = (reg * (q_vc * q_vc).sum(dim=-1)) if reg else 0.0
        loss = loss + ((torch.log(sigmoid_exact(f_pos)) - pos_reg) * af).sum()
        cavge = g_pos[:, None] * q_vc
        dv_center = g_pos[:, None] * cavg
        if reg:
            dv_center = dv_center - two_ar * v_c * af[:, None]

    # shared negatives (strided tiles); v-half gathered from the fused table
    P = neg_pool if neg_pool and neg_pool > 1 else 1
    negs = inputs.neg_ids                                  # [T, P*K]
    K = negs.shape[1] // P
    v_n = table[negs][..., D:].to(dt)                      # [T, P*K, D]
    cavg3 = to_tiles(cavg, T, G)
    af3 = to_tiles(af, T, G)
    centers3 = to_tiles(centers, T, G)
    q_vn = quantize(v_n, bl)
    f_neg = torch.bmm(cavg3, q_vn.transpose(1, 2))         # [T, G, P*K]
    skip = negs[:, None, :] != centers3[:, :, None]
    m3 = skip.to(dt) * af3[:, :, None]
    if P > 1:
        m3 = m3 * pool_mask(G, K, P, dt, dev)[None]
    g_neg = (0.0 - sigmoid_lut(f_neg)) * alpha * m3
    neg_reg = ((reg * (q_vn * q_vn).sum(dim=-1))[:, None, :]
               if reg else 0.0)
    loss = loss + ((torch.log(sigmoid_exact(-f_neg)) - neg_reg) * m3).sum()
    cavge = cavge + from_tiles(torch.bmm(g_neg, q_vn), B)
    dv_neg = torch.bmm(g_neg.transpose(1, 2), cavg3)       # [T, P*K, D]
    if reg:
        visits = m3.sum(dim=1)
        dv_neg = dv_neg - two_ar * v_n * visits[:, :, None]

    # u updates grouped by position (banded windowed sums)
    M_af = Mb * af.reshape(Nt, btile)[:, :, None]
    du_slab, cnt = banded_usum(M_af, cavge, B, W)
    if reg:
        du_slab = du_slab - two_ar * u_slab * cnt[:, None]

    # ONE fused row set for u-positions + center v-rows, then the
    # negative rows (u-half zero)
    dv_slab = torch.zeros((B + 2 * W, D), dtype=dt, device=dev)
    dv_slab[W:W + B] = dv_center
    fused_rows = torch.cat([du_slab, dv_slab], dim=1)      # [B+2W, 2D]
    nd = dv_neg.reshape(-1, D)
    neg_rows = torch.cat([torch.zeros_like(nd), nd], dim=1)
    if scatter_impl in ("span", "grmw"):
        # one sorted call for slab + negative rows (kernels/span_scatter.py,
        # kernels/group_rmw.py); float32 rows round to the table dtype
        # inside the kernels
        all_rows = torch.cat([fused_rows, neg_rows])
        plan = span_plan
        if plan is None:
            plan = scatter_plan(scatter_impl,
                                torch.cat([slab_ids, negs.reshape(-1)]),
                                table, span_chunk)
        if scatter_impl == "span":
            scatter_add_span_planned(table, plan, all_rows)
        else:
            scatter_add_grmw_planned(table, plan, all_rows, chunk=span_chunk)
    else:
        table.index_add_(0, slab_ids, fused_rows.to(table.dtype))
        table.index_add_(0, negs.reshape(-1), neg_rows.to(table.dtype))
    return table, loss


def make_fused_train_chunk(hyper: CBOWHyper, vocab_size: int,
                           batch_size: int, steps: int, neg_sharing: int,
                           neg_pool: int = 1, banded: int = 0,
                           scatter_impl: str = "add",
                           context_pallas: bool = False,
                           loop_mode: str = "scan", span_chunk: int = 128):
    """chunk(table, tokens, sent_ids, atab, scalars, gen, n_steps=None,
    shrinks=None, negs=None) -> (table, loss_sum).

    Runs n_steps (default `steps`) synchronous steps on the fused table IN
    PLACE.  tokens/sent_ids are the epoch arrays on the table's device;
    step s takes centers at base0 + s*B.  The LR decays linearly per step
    with the reference's 1e-4*alpha0 floor (reference :391-392), in
    float32.  The window shrinks [S, B] and negatives [S, B/G, P*K] of all
    steps are drawn from `gen` at chunk entry unless injected; with the
    span or grmw scatter the sort plan of all steps is built once here.

    `loop_mode` "scan", "fori" and "unroll" are accepted as in the JAX
    package and run the same in-place Python loop: the JAX modes differ in
    how XLA carries the table (lax.scan double-buffers it, which is why the
    capacity runbook asks for fori), and an in-place PyTorch table is never
    copied, so there is nothing for them to choose between here."""
    if scatter_impl not in SCATTER_IMPLS:
        raise ValueError(f"unknown scatter_impl {scatter_impl!r} "
                         f"(supported: {', '.join(SCATTER_IMPLS)})")
    if loop_mode not in LOOP_MODES:
        raise ValueError(f"unknown loop_mode {loop_mode!r} "
                         f"(supported: {', '.join(LOOP_MODES)})")
    B, W, K = batch_size, hyper.window, hyper.negative
    P = neg_pool if (neg_pool and neg_pool > 1) else 1
    if not neg_sharing or B % neg_sharing:
        raise ValueError(f"neg_sharing ({neg_sharing}) must be > 0 and "
                         f"divide batch_size ({B})")
    T = B // neg_sharing
    f32 = torch.float32

    def chunk(table: torch.Tensor, tokens: torch.Tensor,
              sent_ids: torch.Tensor, atab: AliasTable,
              scalars: ChunkScalars, gen: Optional[torch.Generator] = None,
              n_steps: Optional[int] = None,
              shrinks: Optional[torch.Tensor] = None,
              negs: Optional[torch.Tensor] = None):
        dev = table.device
        S = steps if n_steps is None else n_steps
        lo = scalars.base0 - W
        hi = lo + S * B + 2 * W
        if lo < 0 or hi > tokens.shape[0]:
            raise ValueError(f"chunk slab range [{lo}, {hi}) outside the "
                             f"epoch arrays of length {tokens.shape[0]}")
        if shrinks is None:
            shrinks = torch.randint(0, W, (S, B), generator=gen, device=dev)
        if negs is None:
            negs = draw_negatives(gen, atab, (S, T, P * K), vocab_size)
        # per-step LR, float32 like the JAX chunk's traced scalars
        s_f = torch.arange(S, dtype=f32, device=dev)
        alpha0 = torch.tensor(scalars.alpha0, dtype=f32, device=dev)
        wca = (torch.tensor(scalars.wca_start, dtype=f32, device=dev)
               + s_f * torch.tensor(scalars.wca_per_step, dtype=f32,
                                    device=dev))
        alphas = alpha0 * (1.0 - wca / torch.tensor(scalars.denom, dtype=f32,
                                                    device=dev))
        alphas = torch.maximum(alphas, alpha0 * 1e-4)
        slab_tokens = tokens[lo:hi].unfold(0, B + 2 * W, B)   # [S, B+2W]
        slab_sents = sent_ids[lo:hi].unfold(0, B + 2 * W, B)
        plans = None
        if scatter_impl in ("span", "grmw"):
            # hoisted: every step's scatter ids are known at chunk entry
            ids_all = torch.cat([slab_tokens.clamp_min(0),
                                 negs.reshape(S, -1)], dim=1)
            plans = scatter_plan(scatter_impl, ids_all, table, span_chunk)
        loss = torch.zeros((), dtype=f32, device=dev)
        for s in range(S):
            inputs = SlabInputs(slab_tokens=slab_tokens[s],
                                slab_sents=slab_sents[s],
                                shrink=shrinks[s], neg_ids=negs[s])
            table, step_loss = fused_slab_step(
                table, inputs, alphas[s], hyper, B, neg_sharing,
                neg_pool=P, banded=banded, scatter_impl=scatter_impl,
                span_plan=None if plans is None else plans.step(s),
                context_pallas=context_pallas, span_chunk=span_chunk)
            loss = loss + step_loss
        return table, loss

    return chunk
