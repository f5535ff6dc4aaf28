"""Skip-gram with negative sampling (SGNS), per-pair negatives, in plain
float32 PyTorch: the reference that tests/test_torch_skipgram_pairs.py
holds the port's `-neg-per-pair 1` route against.

It follows word2vec.c's skip-gram loop (`cbow == 0`) and arXiv 1310.4546
§2.2: for every (center, context) pair the context word's input row
(u) predicts the center word's output row (v), against K negatives drawn
for that pair; a negative equal to the center is skipped.  Word2Bits'
contract on top (reference src/word2bits.cpp): rows are quantized on
read (`quantize`), the gradient takes the table sigmoid (`sigmoid_lut`),
the loss the exact one (`sigmoid_exact`), and with reg each visit of a
row subtracts 2*alpha*reg times the row (the loss reg * |q|^2).

Departures from word2vec.c, as in the port: a step is a synchronous
minibatch of B centers, every pair computed from the rows as they were
before the step, not Hogwild per pair; pairs masked out (padding, a
sentence boundary, outside the shrunk window) have negatives drawn that
are then masked; the updates of a row are summed in float32 and added to
the stored row once a step.  The negatives of a step are [B, 2W*K],
pair-major: pair oi of center b (offsets -W..-1, 1..W) takes lanes
oi*K .. oi*K+K-1 of row b.

Imports torch only: nothing of either package, so it runs beside the
card.  benchmark/skipgram.py holds the same step (bit for bit, on the
benchmark's shared pieces); the two are held equal by
benchmark/tests/test_bench_skipgram.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EXP_TABLE_SIZE = 1000
MAX_EXP = 6.0
LUT_SCALE = 83.0          # C integer division: 1000 / 6 / 2
EDGE_TOL = 1e-4          # a score this near +-6 may sit on either side
BLOCK = 512              # centers a block: the [n, 2W, K+1, D] products


def quantize(x: torch.Tensor, bitlevel: int) -> torch.Tensor:
    """2^bitlevel levels: sign(x)/3 at bitlevel 1 (0 maps to +1/3)."""
    if bitlevel == 0:
        return x

    def const(c):
        return torch.tensor(c, dtype=x.dtype, device=x.device)

    sign = torch.where(x < 0, const(-1.0), const(1.0))
    mag = torch.abs(x)
    if bitlevel == 1:
        return sign * (const(1.0) / const(3.0))
    if bitlevel == 2:
        return sign * torch.where(mag <= 0.5, const(0.25), const(0.75))
    if bitlevel == 3:
        return x * const(0.0)
    seg = float(2 ** (bitlevel - 1))
    casted = torch.minimum(torch.floor(mag * seg + 0.5), const(seg))
    return sign * (casted / const(seg))


def sigmoid_lut(f: torch.Tensor) -> torch.Tensor:
    """The gradient path's table: sigma at the bin of f, +-6 saturated."""
    idx = torch.floor((f + MAX_EXP) * LUT_SCALE)
    x_bin = (idx / EXP_TABLE_SIZE * 2.0 - 1.0) * MAX_EXP
    one = torch.ones((), dtype=f.dtype, device=f.device)
    return torch.where(f > MAX_EXP, one,
                       torch.where(f < -MAX_EXP, 0 * one,
                                   torch.sigmoid(x_bin)))


def sigmoid_exact(f: torch.Tensor) -> torch.Tensor:
    """The loss path's sigmoid: 1 above +6, 1e-9 below -6."""
    one = torch.ones((), dtype=f.dtype, device=f.device)
    return torch.where(f > MAX_EXP, one,
                       torch.where(f < -MAX_EXP, 1e-9 * one,
                                   torch.sigmoid(f)))


def store(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to the storage dtype (float8 e4m3 saturates at +-448)."""
    if dtype == torch.float8_e4m3fn:
        x = x.float().clamp(-448.0, 448.0)
    return x.to(dtype)


class Rows:
    """The rows of (u, v) that a step touches, in `storage` dtype: ids [R]
    sorted, u and v [R, D]; `index` maps global ids to rows."""

    def __init__(self, ids: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 storage: torch.dtype):
        self.ids = ids
        self.u = store(u, storage)
        self.v = store(v, storage)
        self.storage = storage
        self.loss_bounds = (0.0, 0.0)

    def index(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.searchsorted(self.ids, ids)


@dataclass(frozen=True)
class Hyper:
    bitlevel: int
    size: int
    window: int
    negative: int
    batch: int
    reg: float = 0.0


def step(rows, slab_tokens: torch.Tensor, slab_sents: torch.Tensor,
         shrink: torch.Tensor, negs: torch.Tensor, alpha: float, hp: Hyper,
         compute: torch.dtype = torch.float32, half: bool = False,
         block: int = BLOCK) -> torch.Tensor:
    """One synchronous step over the B centers at slab positions W..W+B-1
    (slab_tokens, slab_sents [B+2W], -1 padding; shrink [B]; negs
    [B, 2W*K]) on `rows` in place; returns the step's loss (float32) and
    leaves in rows.loss_bounds the least and the most it can be when the
    scores at exactly +-6 fall on either side of the saturation.
    `compute` is the arithmetic's precision; `half` keeps only the first
    B/2 centers and doubles the rate.  Computed in blocks of `block`
    centers; every update is summed per row in float32 over the step."""
    B, W, D, K, bl = hp.batch, hp.window, hp.size, hp.negative, hp.bitlevel
    dev = rows.u.device
    a = torch.tensor(alpha * (2.0 if half else 1.0), dtype=torch.float32,
                     device=dev).to(compute)
    two_ar = 2.0 * a * hp.reg
    slab = slab_tokens.clamp_min(0)
    centers = slab[W:W + B]
    csent = slab_sents[W:W + B]
    offsets = [o for o in range(-W, W + 1) if o != 0]
    odist = torch.tensor([abs(o) for o in offsets], device=dev)
    ctx = torch.stack([slab[W + o:W + o + B] for o in offsets], dim=1)
    ctx_sent = torch.stack([slab_sents[W + o:W + o + B] for o in offsets],
                           dim=1)
    valid = csent >= 0
    if half:
        valid = valid & (torch.arange(B, device=dev) < B // 2)
    mask = ((odist[None, :] <= (W - shrink)[:, None])
            & (ctx_sent == csent[:, None]) & valid[:, None]
            & (ctx_sent >= 0))                                 # [B, 2W]
    negs3 = negs.reshape(B, 2 * W, K)
    R = rows.ids.numel()
    acc_u = torch.zeros((R, D), dtype=torch.float32, device=dev)
    acc_v = torch.zeros((R, D), dtype=torch.float32, device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    lo = torch.zeros((), dtype=torch.float32, device=dev)
    hi = torch.zeros((), dtype=torch.float32, device=dev)
    for b0 in range(0, B, block):
        b1 = min(B, b0 + block)
        n = b1 - b0
        m = mask[b0:b1].to(compute)                            # [n, 2W]
        c = centers[b0:b1]
        r_in = rows.index(ctx[b0:b1])                          # [n, 2W]
        x_in = rows.u[r_in].to(compute)                        # [n, 2W, D]
        q_in = quantize(x_in, bl)
        # targets of each pair: the center, then its K negatives
        r_t = torch.cat([rows.index(c)[:, None, None].expand(n, 2 * W, 1),
                         rows.index(negs3[b0:b1])], dim=2)     # [n,2W,K+1]
        x_t = rows.v[r_t].to(compute)                          # [.., K+1, D]
        q_t = quantize(x_t, bl)
        f = torch.matmul(q_t, q_in[..., None])[..., 0]         # [n,2W,K+1]
        label = torch.zeros_like(f)
        label[..., 0] = 1.0
        eligible = torch.cat(
            [torch.ones((n, 2 * W, 1), dtype=torch.bool, device=dev),
             negs3[b0:b1] != c[:, None, None]], dim=2)
        dm = eligible.to(compute) * m[..., None]
        g = (label - sigmoid_lut(f)) * a * dm
        # the loss: log sigma(+-f) less reg * |q|^2 of the pair's rows
        signed = torch.where(label > 0, f, -f).float()
        lg = torch.log(sigmoid_exact(signed))
        rg = 0.0
        if hp.reg:
            rg = hp.reg * ((q_t * q_t).sum(dim=-1) + label
                           * (q_in * q_in).sum(dim=-1)[..., None]).float()
        dmf = dm.float()
        terms = (lg - rg) * dmf
        # at |f| = 6 the loss path jumps; bitlevel-1 scores are multiples
        # of 1/9 and land on the edge exactly, where float order picks the
        # side: the other side's value there
        edge = ((signed.abs() - MAX_EXP).abs() < EDGE_TOL) & (dmf > 0)
        other = torch.where(signed.abs() > MAX_EXP,
                            torch.log(torch.sigmoid(signed)),
                            torch.where(signed > 0, 0.0, math.log(1e-9)))
        other = torch.where(edge, (other - rg) * dmf, terms)
        loss = loss + terms.sum()
        lo = lo + torch.minimum(terms, other).sum()
        hi = hi + torch.maximum(terms, other).sum()
        # v rows: each target's g times the pair's input, less its decay
        dv = g[..., None] * q_in[:, :, None, :]                # [n,2W,K+1,D]
        du = torch.matmul(g[:, :, None, :], q_t)[:, :, 0]      # [n, 2W, D]
        du = du * m[..., None]
        if hp.reg:
            dv = dv - two_ar * x_t * dm[..., None]
            du = du - two_ar * x_in * m[..., None]
        acc_u.index_add_(0, r_in.reshape(-1), du.reshape(-1, D).float())
        acc_v.index_add_(0, r_t.reshape(-1), dv.reshape(-1, D).float())
    scale = 2.0 if half else 1.0
    rows.loss_bounds = (float(lo) * scale, float(hi) * scale)
    rows.u = store(rows.u.float() + acc_u, rows.storage)
    rows.v = store(rows.v.float() + acc_v, rows.storage)
    return (loss * scale).float()


def table_step(u: torch.Tensor, v: torch.Tensor, slab_tokens, slab_sents,
               shrink, negs, alpha: float, hp: Hyper, **kw):
    """`step` on whole (u, v) tables [V, D]: returns (u, v, loss), new
    tables in the dtype of u."""
    ids = torch.arange(u.shape[0], device=u.device)
    rows = Rows(ids, u, v, u.dtype)
    loss = step(rows, slab_tokens, slab_sents, shrink, negs, alpha, hp,
                **kw)
    return rows.u, rows.v, loss


def chunk(u: torch.Tensor, v: torch.Tensor, tokens: torch.Tensor,
          sents: torch.Tensor, base0: int, shrinks: torch.Tensor,
          negs: torch.Tensor, alphas, hp: Hyper):
    """S sequential steps on whole tables: step s takes the centers at
    tokens[base0 + s*B : base0 + (s+1)*B] and its slab of W words either
    side; shrinks [S, B], negs [S, B, 2W*K], alphas [S].  Returns (u, v,
    the float32 sum of the steps' losses)."""
    B, W = hp.batch, hp.window
    total = torch.zeros((), dtype=torch.float32, device=u.device)
    for s in range(shrinks.shape[0]):
        lo = base0 + s * B - W
        u, v, loss = table_step(u, v, tokens[lo:lo + B + 2 * W],
                                sents[lo:lo + B + 2 * W], shrinks[s],
                                negs[s], float(alphas[s]), hp)
        total = total + loss
    return u, v, total
