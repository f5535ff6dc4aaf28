"""CBOW + negative sampling: hyperparameters, the reference-shaped step and
the per-chunk LR schedule.

The counterpart of the JAX package's models/cbow.py.  Reference math
(reference src/word2bits.cpp:363-516), per step given the same batch:
  * context_avg = mean over context words of quantize(u[w]) (:438-449)
  * f_d = context_avg . quantize(v[target_d]);
    g_d = (label - sigma_LUT(f)) * alpha with the +-6-saturated LUT
    (:464-475)
  * a negative equal to the center is skipped, not resampled (:458)
  * v[target] += g * context_avg - 2*alpha*reg*v[target]   (:489-491)
  * u[ctx] += sum_d g_d * quantize(v[target_d]) - 2*alpha*reg*u[ctx],
    NOT divided by the context count (:494-503)
  * loss = sum_d log sigma_exact(+-f_d) - reg*||quantize(v_d)||^2
           - reg*||quantize(u_ctx)||^2 per context word (:437-445, :480-484)
  * linear LR decay over the whole run with floor 1e-4*alpha0 (:391-392)

`cbow_minibatch_update` gathers B*2W context rows; the slab step
(models/cbow_slab.py) computes the same update from one B+2W slab and is
tested equal to it.  PyTorch idiom: u and v are updated IN PLACE (the JAX
package donates them), the chunk is a Python loop, and its randomness comes
from a torch.Generator at chunk entry or is injected by the caller.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.scatter import scatter_add
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut


@dataclass(frozen=True)
class CBOWHyper:
    """Static hyperparameters."""

    bitlevel: int = 1
    size: int = 100
    window: int = 5
    negative: int = 5
    reg: float = 0.0

    def __post_init__(self):
        if self.bitlevel == 3:
            raise ValueError("bitlevel 3 is a reference quantizer hole; rejected")


class Batch(NamedTuple):
    """An assembled CBOW minibatch."""

    centers: torch.Tensor    # int [B] (clamped to valid ids; see valid)
    ctx_ids: torch.Tensor    # int [B, 2W]
    ctx_mask: torch.Tensor   # bool [B, 2W] — in-sentence, in-window, valid
    neg_ids: torch.Tensor    # int [B, K]
    valid: torch.Tensor      # bool [B] — center is a real (non-pad) token


def _context_stats(u: torch.Tensor, batch: Batch, hyper: CBOWHyper):
    """Gathered and quantized context rows: (u_rows, context_avg, active,
    ctx_reg), the masked mean and the per-center -reg term's sum."""
    dt = u.dtype
    u_rows = u[batch.ctx_ids]                                  # [B, 2W, D]
    q_rows = quantize(u_rows, hyper.bitlevel)
    m = batch.ctx_mask[..., None].to(dt)
    csum = (q_rows * m).sum(dim=1)
    cw = batch.ctx_mask.sum(dim=1).to(dt)
    active = batch.valid & (cw > 0)
    context_avg = csum / torch.clamp_min(cw, 1.0)[:, None]
    ctx_reg = ((q_rows * q_rows).sum(dim=-1) * batch.ctx_mask).sum(dim=1)
    return u_rows, context_avg, active, ctx_reg


def _negative_stats(v: torch.Tensor, batch: Batch, context_avg, active,
                    alpha, hyper: CBOWHyper):
    """Center + negatives scored: (targets, v_rows, q_v, f, g, dmask,
    loss sum), labels 1, 0...; the skip quirk masks a negative equal to
    the center."""
    dt = v.dtype
    B = batch.centers.shape[0]
    targets = torch.cat([batch.centers[:, None], batch.neg_ids], dim=1)
    labels = torch.zeros(targets.shape, dtype=dt, device=v.device)
    labels[:, 0] = 1.0
    dmask = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=v.device),
                       batch.neg_ids != batch.centers[:, None]],
                      dim=1) & active[:, None]
    v_rows = v[targets]                                        # [B, K+1, D]
    q_v = quantize(v_rows, hyper.bitlevel)
    f = torch.bmm(q_v, context_avg[:, :, None])[..., 0]        # [B, K+1]
    g = (labels - sigmoid_lut(f)) * alpha * dmask.to(dt)
    signed_f = torch.where(labels > 0, f, -f)
    v_reg = hyper.reg * (q_v * q_v).sum(dim=-1)
    nloss = ((torch.log(sigmoid_exact(signed_f)) - v_reg)
             * dmask.to(dt)).sum()
    return targets, v_rows, q_v, f, g, dmask, nloss


def cbow_minibatch_update(u: torch.Tensor, v: torch.Tensor, batch: Batch,
                          alpha, hyper: CBOWHyper):
    """One synchronous SGD step on u and v IN PLACE. Returns (u, v, loss).
    Computes in the tables' dtype, as the JAX package's step does."""
    dt = u.dtype
    alpha = torch.as_tensor(alpha, dtype=dt, device=u.device)
    u_rows, context_avg, active, ctx_reg = _context_stats(u, batch, hyper)
    targets, v_rows, q_v, _, g, dmask, nloss = _negative_stats(
        v, batch, context_avg, active, alpha, hyper)

    D = u.shape[1]
    two_ar = 2.0 * alpha * hyper.reg
    # v[target] += g*context_avg - 2*alpha*reg*v[target]
    dv = (g[..., None] * context_avg[:, None, :]
          - two_ar * v_rows * dmask[..., None])
    scatter_add(v, targets.reshape(-1), dv.reshape(-1, D))
    # u[ctx] += sum_d g_d*quantize(v[target_d]) - 2*alpha*reg*u[ctx]
    context_avge = torch.bmm(g[:, None, :], q_v)[:, 0]         # [B, D]
    cm = (batch.ctx_mask & active[:, None])[..., None].to(dt)
    du = (context_avge[:, None, :] - two_ar * u_rows) * cm
    scatter_add(u, batch.ctx_ids.reshape(-1), du.reshape(-1, D))
    loss = nloss - hyper.reg * (ctx_reg * active.to(dt)).sum()
    return u, v, loss


def cbow_forward_scores(u: torch.Tensor, v: torch.Tensor, batch: Batch,
                        hyper: CBOWHyper):
    """The forward pass alone: (scores f [B, K+1], loss), the center's
    score first; u and v are not changed (the JAX package's
    cbow_forward_scores, for the evaluation and entry paths)."""
    _, context_avg, active, ctx_reg = _context_stats(u, batch, hyper)
    _, _, _, f, _, _, nloss = _negative_stats(
        v, batch, context_avg, active,
        torch.ones((), dtype=u.dtype, device=u.device), hyper)
    loss = nloss - hyper.reg * (ctx_reg * active.to(u.dtype)).sum()
    return f, loss


def assemble_batch(tokens: torch.Tensor, sent_ids: torch.Tensor, base: int,
                   shrink: torch.Tensor, neg_ids: torch.Tensor,
                   batch_size: int, window: int) -> Batch:
    """The Batch of `batch_size` consecutive centers at padded-array offset
    `base`, with window shrink b in [0, window) per center (reference
    src/word2bits.cpp:428-434): effective half-width window - b, and no
    context across a sentence boundary.  The JAX package draws `shrink`
    from a key here; the port takes it as an input."""
    B, W = batch_size, window
    sl = tokens[base - W:base + B + W]
    ss = sent_ids[base - W:base + B + W]
    csent = ss[W:W + B]
    offsets = [o for o in range(-W, W + 1) if o != 0]
    ctx_ids = torch.stack([sl[W + o:W + o + B] for o in offsets], dim=1)
    ctx_sent = torch.stack([ss[W + o:W + o + B] for o in offsets], dim=1)
    odist = torch.tensor([abs(o) for o in offsets], device=tokens.device)
    in_window = odist[None, :] <= (W - shrink)[:, None]
    valid = csent >= 0
    mask = (in_window & (ctx_sent == csent[:, None]) & valid[:, None]
            & (ctx_sent >= 0))
    return Batch(centers=sl[W:W + B].clamp_min(0),
                 ctx_ids=ctx_ids.clamp_min(0), ctx_mask=mask,
                 neg_ids=neg_ids, valid=valid)


class ChunkScalars(NamedTuple):
    """Per-chunk scalars of the LR schedule (reference :379-393), as Python
    numbers; the chunk turns them into float32 device scalars."""

    base0: int            # padded-array offset of the chunk's first center
    alpha0: float         # starting_alpha
    wca_start: float      # word_count_actual at chunk start
    wca_per_step: float   # words consumed per step (B * train_words/centers)
    denom: float          # iter * train_words + 1


def step_alphas(scalars: ChunkScalars, S: int, device) -> torch.Tensor:
    """[S] float32 LR of each step of a chunk: linear decay with the
    reference's 1e-4*alpha0 floor (reference :391-392), in float32 like
    the JAX chunk's traced scalars."""
    f32 = dict(dtype=torch.float32, device=device)
    alpha0 = torch.tensor(scalars.alpha0, **f32)
    wca = (torch.tensor(scalars.wca_start, **f32)
           + torch.arange(S, **f32) * torch.tensor(scalars.wca_per_step,
                                                   **f32))
    alphas = alpha0 * (1.0 - wca / torch.tensor(scalars.denom, **f32))
    return torch.maximum(alphas, alpha0 * 1e-4)


def chunk_slabs(tokens: torch.Tensor, sent_ids: torch.Tensor, base0: int,
                S: int, B: int, W: int):
    """([S, B+2W] slab tokens, [S, B+2W] slab sentence ids) of the S steps
    whose first centers sit at base0 + s*B, as strided views."""
    lo = base0 - W
    hi = lo + S * B + 2 * W
    if lo < 0 or hi > tokens.shape[0]:
        raise ValueError(f"chunk slab range [{lo}, {hi}) outside the "
                         f"epoch arrays of length {tokens.shape[0]}")
    return (tokens[lo:hi].unfold(0, B + 2 * W, B),
            sent_ids[lo:hi].unfold(0, B + 2 * W, B))


def make_train_chunk(hyper: CBOWHyper, vocab_size: int, batch_size: int,
                     steps: int):
    """chunk(u, v, tokens, sent_ids, atab, scalars, gen=None, n_steps=None,
    shrinks=None, negs=None) -> (u, v, loss_sum): n_steps (default
    `steps`) reference-shaped steps IN PLACE, per-center negatives [S, B, K]
    and shrinks [S, B] drawn from `gen` at chunk entry unless injected."""
    from word2bits_tpu_torch.sampling.unigram import draw_negatives

    B, W, K = batch_size, hyper.window, hyper.negative

    def chunk(u, v, tokens, sent_ids, atab, scalars: ChunkScalars,
              gen: Optional[torch.Generator] = None,
              n_steps: Optional[int] = None,
              shrinks: Optional[torch.Tensor] = None,
              negs: Optional[torch.Tensor] = None):
        dev = u.device
        S = steps if n_steps is None else n_steps
        chunk_slabs(tokens, sent_ids, scalars.base0, S, B, W)  # range check
        if shrinks is None:
            shrinks = torch.randint(0, W, (S, B), generator=gen, device=dev)
        if negs is None:
            negs = draw_negatives(gen, atab, (S, B, K), vocab_size)
        alphas = step_alphas(scalars, S, dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(S):
            batch = assemble_batch(tokens, sent_ids, scalars.base0 + s * B,
                                   shrinks[s], negs[s], B, W)
            u, v, step_loss = cbow_minibatch_update(u, v, batch, alphas[s],
                                                    hyper)
            loss = loss + step_loss
        return u, v, loss

    return chunk
