"""Interleaved-table CBOW step: u and v fused into one (V, 2D) table.

table[:, :D] = u and table[:, D:] = v, so the u rows updated by slab
position and the v rows updated for the centers carry the same word ids and
go out in ONE scatter of B+2W double-width rows; the center v rows ride the
slab gather.  Semantics are those of the JAX package's
models/cbow_fused.py, restricted to what the ported configurations run:
shared negatives (neg_sharing > 0) with pools, through the fused score
kernel (`use_pallas`) or its plain version; the banded or shifted-sum
windowed sums, with or without the fused context kernel; and the `add`
(index_add_), `span` (sorted kernel, the shipped throughput configuration)
or `grmw` (sorted group-RMW kernel, the 3.7M x 800d capacity
configuration) scatter.  The context, positive, negative and u-sum phases
are the slab step's (models/cbow_slab.py).

PyTorch idiom: the table is updated IN PLACE (JAX donates it), the S steps
of a chunk are a Python loop, and the chunk's randomness comes from an
explicit torch.Generator — drawn at chunk entry for all S steps, or
injected by the caller.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from word2bits_tpu_torch.kernels.group_rmw import (
    GroupPlan, group_plan, group_rows, scatter_add_grmw_planned)
from word2bits_tpu_torch.kernels.span_scatter import (
    SpanPlan, scatter_add_span_planned, span_plan)
from word2bits_tpu_torch.models.cbow import (
    CBOWHyper, ChunkScalars, chunk_slabs, step_alphas)
from word2bits_tpu_torch.models.cbow_slab import (
    SlabInputs, _numpy_to_torch, positive_phase, shared_negative_phase,
    u_update_rows)
from word2bits_tpu_torch.sampling.unigram import AliasTable, draw_negatives

SCATTER_IMPLS = ("add", "span", "grmw")
LOOP_MODES = ("scan", "fori", "unroll")


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
                    context_pallas: bool = False, span_chunk: int = 128,
                    use_pallas: bool = False):
    """One synchronous step on the fused (V, 2D) table, IN PLACE.
    Returns (table, loss) with loss a float32 0-d tensor on the device.
    `span_plan` is the step's hoisted plan for the `span` (SpanPlan) or
    `grmw` (GroupPlan) scatter; `span_chunk` is grmw's `chunk`.
    `use_pallas` runs the shared-negative phase through the fused score
    kernel (kernels/score_pallas.py; the `add` scatter only, as the
    configuration requires)."""
    if not neg_sharing:
        raise ValueError("fused table step requires neg_sharing > 0")
    if scatter_impl not in SCATTER_IMPLS:
        raise ValueError(f"unknown scatter_impl {scatter_impl!r} "
                         f"(supported: {', '.join(SCATTER_IMPLS)})")
    if use_pallas and scatter_impl != "add":
        raise ValueError("use_pallas runs with scatter_impl='add' only")
    B, W = batch_size, hyper.window
    D = table.shape[1] // 2
    dt = torch.float32
    dev = table.device
    G = neg_sharing
    if B % G:
        raise ValueError(f"batch {B} not divisible by neg tile {G}")
    alpha = torch.as_tensor(alpha, dtype=dt, device=dev)

    slab_ids = inputs.slab_tokens.clamp_min(0)             # [B+2W]
    centers = slab_ids[W:W + B]
    # ONE gather: u rows for all positions + v rows for the centers
    slab_raw = table[slab_ids]                             # [B+2W, 2D]
    pos = positive_phase(slab_raw[:, :D], slab_raw[W:W + B, D:], inputs,
                         alpha, hyper, B, banded, context_pallas)
    # shared negatives (strided tiles); v-half gathered from the fused table
    P = neg_pool if neg_pool and neg_pool > 1 else 1
    negs = inputs.neg_ids                                  # [T, P*K]
    v_n = table[negs][..., D:].to(dt)                      # [T, P*K, D]
    cavge_neg, dv_neg, nloss = shared_negative_phase(
        pos.cavg, pos.af, centers, negs, v_n, alpha, hyper, B, G, P,
        use_pallas)
    loss = pos.loss + nloss
    du_slab = u_update_rows(pos, pos.cavge + cavge_neg, alpha, hyper, B)

    # ONE fused row set for u-positions + center v-rows, then the
    # negative rows (u-half zero)
    dv_slab = torch.zeros((B + 2 * W, D), dtype=dt, device=dev)
    dv_slab[W:W + B] = pos.dv_center
    fused_rows = torch.cat([du_slab, dv_slab], dim=1)      # [B+2W, 2D]
    neg_rows = torch.cat([torch.zeros_like(dv_neg), dv_neg], dim=1)
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
                           loop_mode: str = "scan", span_chunk: int = 128,
                           use_pallas: bool = False):
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
    if use_pallas and scatter_impl != "add":
        raise ValueError("use_pallas runs with scatter_impl='add' only")
    B, W, K = batch_size, hyper.window, hyper.negative
    P = neg_pool if (neg_pool and neg_pool > 1) else 1
    if not neg_sharing or B % neg_sharing:
        raise ValueError(f"neg_sharing ({neg_sharing}) must be > 0 and "
                         f"divide batch_size ({B})")
    T = B // neg_sharing

    def chunk(table: torch.Tensor, tokens: torch.Tensor,
              sent_ids: torch.Tensor, atab: AliasTable,
              scalars: ChunkScalars, gen: Optional[torch.Generator] = None,
              n_steps: Optional[int] = None,
              shrinks: Optional[torch.Tensor] = None,
              negs: Optional[torch.Tensor] = None):
        dev = table.device
        S = steps if n_steps is None else n_steps
        slab_tokens, slab_sents = chunk_slabs(tokens, sent_ids,
                                              scalars.base0, S, B, W)
        if shrinks is None:
            shrinks = torch.randint(0, W, (S, B), generator=gen, device=dev)
        if negs is None:
            negs = draw_negatives(gen, atab, (S, T, P * K), vocab_size)
        alphas = step_alphas(scalars, S, dev)
        plans = None
        if scatter_impl in ("span", "grmw"):
            # hoisted: every step's scatter ids are known at chunk entry
            ids_all = torch.cat([slab_tokens.clamp_min(0),
                                 negs.reshape(S, -1)], dim=1)
            plans = scatter_plan(scatter_impl, ids_all, table, span_chunk)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(S):
            inputs = SlabInputs(slab_tokens=slab_tokens[s],
                                slab_sents=slab_sents[s],
                                shrink=shrinks[s], neg_ids=negs[s])
            table, step_loss = fused_slab_step(
                table, inputs, alphas[s], hyper, B, neg_sharing,
                neg_pool=P, banded=banded, scatter_impl=scatter_impl,
                span_plan=None if plans is None else plans.step(s),
                context_pallas=context_pallas, span_chunk=span_chunk,
                use_pallas=use_pallas)
            loss = loss + step_loss
        return table, loss

    return chunk
