"""fastText's subword skip-gram (Bojanowski et al. 2017, arXiv 1607.04606,
the `fasttext skipgram` command) in plain float32 PyTorch: the reference
that tests/test_torch_fasttext.py holds the port's `-model fasttext`
route against.

A word's subword rows G_w (fastText's Dictionary::initNgrams) are its own
row, then one row V + fnv1a(g) % bucket for each n-gram g of minn..maxn
bytes of `<word>`, by start and then by length, duplicates kept, a lone
`<` or `>` never an n-gram; `</s>` has its own row only.  The hash is
fastText's 32-bit FNV-1a with each byte sign-extended as its int8
(`subwords`, one word at a time).

Per center b, h_b is the mean of G_b's quantized input rows (fastText's
computeHidden).  Each (center, context c) pair scores c's output row,
the positive, and the pair's own K negatives (a negative equal to c
skipped) against h_b; each output row gets g * h_b, and g_b, the
gradient for h_b summed over b's pairs, is added whole to every row of
G_b, a duplicate twice (fastText divides by |G| only in its supervised
model).  Word2Bits' contract on top: rows are quantized on read
(`quantize`), the gradient takes the table sigmoid (`sigmoid_lut`), the
loss the exact one (`sigmoid_exact`), and with reg each visit of a row
subtracts 2*alpha*reg times the row (a row of G_b is visited once a pair
of b), the loss reg * |q|^2 of the pair's rows (G_b's once a pair).

Departures from fastText, as in the port: a step is a synchronous
minibatch of B centers, every pair computed from the rows as they were
before the step, not Hogwild per pair; masked pairs' negatives are drawn
and masked; a negative equal to its target is skipped, not redrawn; the
updates of a row are summed in float32 and added to the stored row once a
step.  The negatives of a step are [B, 2W*K], pair-major: pair oi of
center b (offsets -W..-1, 1..W) takes lanes oi*K .. oi*K+K-1 of row b.

Imports torch only: nothing of either package, so it runs beside the
card.  benchmark/fasttext.py holds the same step (bit for bit, on the
benchmark's shared pieces); the two are held equal by
benchmark/tests/test_bench_fasttext.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EXP_TABLE_SIZE = 1000
MAX_EXP = 6.0
LUT_SCALE = 83.0          # C integer division: 1000 / 6 / 2
EDGE_TOL = 1e-4          # a score this near +-6 may sit on either side
BLOCK = 512              # centers a block: the [n, 2W, K+1, D] products
EOS = "</s>"


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


def fnv1a(data: bytes) -> int:
    """fastText's Dictionary::hash: 32-bit FNV-1a, each byte as int8."""
    h = 2166136261
    for b in data:
        h = ((h ^ ((b - 256 if b > 127 else b) & 0xFFFFFFFF))
             * 16777619) & 0xFFFFFFFF
    return h


def subwords(word: str, i: int, V: int, minn: int, maxn: int,
             bucket: int) -> List[int]:
    """G_w of word i of V: i, then its n-grams' bucket rows."""
    if word == EOS:
        return [i]
    b = ("<" + word + ">").encode("utf-8", "surrogateescape")
    return [i] + [V + fnv1a(b[s:s + n]) % bucket
                  for s in range(len(b))
                  for n in range(minn, maxn + 1) if s + n <= len(b)
                  and not (n == 1 and (s == 0 or s + n == len(b)))]


@dataclass
class Bound:
    """The widths and every word's subword rows, a CSR on the device."""
    bitlevel: int
    size: int
    window: int
    negative: int
    batch: int
    offsets: torch.Tensor   # int64 [V + 1]
    ids: torch.Tensor       # int64 [offsets[-1]]
    reg: float = 0.0


def bind(words: List[str], minn: int, maxn: int, bucket: int, device,
         **hyper) -> Bound:
    """`Bound` of `words` (index 0 `</s>`), one word at a time."""
    V = len(words)
    groups = [subwords(w, i, V, minn, maxn, bucket) if maxn else [i]
              for i, w in enumerate(words)]
    offsets = [0]
    for g in groups:
        offsets.append(offsets[-1] + len(g))
    ids = [r for g in groups for r in g]
    return Bound(offsets=torch.tensor(offsets, device=device),
                 ids=torch.tensor(ids, dtype=torch.int64, device=device),
                 **hyper)


class Rows:
    """The rows of the two leaves that a step touches, in `storage`
    dtype: leaf 0 input rows (words, then buckets), leaf 1 output rows,
    each over its own sorted ids; `find` maps global ids to rows."""

    def __init__(self, pairs, storage: torch.dtype):
        self.leaf_ids = [ids for ids, _ in pairs]
        self.leaves = [store(x, storage) for _, x in pairs]
        self.storage = storage
        self.loss_bounds = (0.0, 0.0)

    def find(self, leaf: int, ids: torch.Tensor) -> torch.Tensor:
        return torch.searchsorted(self.leaf_ids[leaf], ids)


def center_subwords(hp: Bound, centers: torch.Tensor):
    """(segment [N], ids [N]): the G_w rows of each center in turn."""
    lens = hp.offsets[centers + 1] - hp.offsets[centers]
    seg = torch.repeat_interleave(torch.arange(centers.numel(),
                                               device=centers.device), lens)
    first = torch.repeat_interleave(hp.offsets[centers], lens)
    within = torch.arange(seg.numel(), device=centers.device) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    return seg, hp.ids[first + within]


def step(rows: Rows, slab_tokens: torch.Tensor, slab_sents: torch.Tensor,
         shrink: torch.Tensor, negs: torch.Tensor, alpha: float, hp: Bound,
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
    dev = rows.leaves[0].device
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
    x_in_all, x_out_all = rows.leaves
    acc_in = torch.zeros(x_in_all.shape, dtype=torch.float32, device=dev)
    acc_out = torch.zeros(x_out_all.shape, dtype=torch.float32, device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    lo = torch.zeros((), dtype=torch.float32, device=dev)
    hi = torch.zeros((), dtype=torch.float32, device=dev)
    for b0 in range(0, B, block):
        b1 = min(B, b0 + block)
        n = b1 - b0
        m = mask[b0:b1].to(compute)                            # [n, 2W]
        # h: the mean of each center's quantized subword rows
        seg, sub = center_subwords(hp, centers[b0:b1])
        r_sub = rows.find(0, sub)
        x_sub = x_in_all[r_sub].to(compute)                    # [N, D]
        q_sub = quantize(x_sub, bl)
        n_sub = torch.bincount(seg, minlength=n).to(compute)
        hidden = torch.zeros((n, D), dtype=compute, device=dev)
        hidden.index_add_(0, seg, q_sub)
        hidden = hidden / n_sub[:, None]
        # targets of each pair: the context, then its K negatives
        targets = torch.cat([ctx[b0:b1, :, None], negs3[b0:b1]], dim=2)
        r_t = rows.find(1, targets)                            # [n,2W,K+1]
        x_t = x_out_all[r_t].to(compute)                       # [.., K+1, D]
        q_t = quantize(x_t, bl)
        f = torch.matmul(q_t, hidden[:, None, :, None])[..., 0]
        label = torch.zeros_like(f)
        label[..., 0] = 1.0
        eligible = torch.cat(
            [torch.ones((n, 2 * W, 1), dtype=torch.bool, device=dev),
             negs3[b0:b1] != ctx[b0:b1, :, None]], dim=2)
        dm = eligible.to(compute) * m[..., None]
        g = (label - sigmoid_lut(f)) * a * dm
        # the loss: log sigma(+-f) less reg * |q|^2 of the pair's rows
        signed = torch.where(label > 0, f, -f).float()
        lg = torch.log(sigmoid_exact(signed))
        rg = 0.0
        if hp.reg:
            in_sq = torch.zeros((n,), dtype=compute, device=dev)
            in_sq.index_add_(0, seg, (q_sub * q_sub).sum(dim=-1))
            rg = hp.reg * ((q_t * q_t).sum(dim=-1) + label
                           * in_sq[:, None, None]).float()
        dmf = dm.float()
        terms = (lg - rg) * dmf
        # at |f| = 6 the loss path jumps; where float order picks the
        # side of a score on the edge, the other side's value there
        edge = ((signed.abs() - MAX_EXP).abs() < EDGE_TOL) & (dmf > 0)
        other = torch.where(signed.abs() > MAX_EXP,
                            torch.log(torch.sigmoid(signed)),
                            torch.where(signed > 0, 0.0, math.log(1e-9)))
        other = torch.where(edge, (other - rg) * dmf, terms)
        loss = loss + terms.sum()
        lo = lo + torch.minimum(terms, other).sum()
        hi = hi + torch.maximum(terms, other).sum()
        # output rows: each target's g times h, less its decay
        dv = g[..., None] * hidden[:, None, None, :]           # [n,2W,K+1,D]
        grad_h = torch.matmul(g.reshape(n, 1, -1),
                              q_t.reshape(n, -1, D))[:, 0]     # [n, D]
        du = grad_h[seg]                                       # [N, D]
        if hp.reg:
            dv = dv - two_ar * x_t * dm[..., None]
            du = du - two_ar * m.sum(dim=1)[seg][:, None] * x_sub
        acc_in.index_add_(0, r_sub, du.float())
        acc_out.index_add_(0, r_t.reshape(-1), dv.reshape(-1, D).float())
    scale = 2.0 if half else 1.0
    rows.loss_bounds = (float(lo) * scale, float(hi) * scale)
    rows.leaves = [store(x_in_all.float() + acc_in, rows.storage),
                   store(x_out_all.float() + acc_out, rows.storage)]
    return (loss * scale).float()


def table_step(u: torch.Tensor, v: torch.Tensor, slab_tokens, slab_sents,
               shrink, negs, alpha: float, hp: Bound, **kw):
    """`step` on whole tables u [V + buckets, D], v [V, D]: returns
    (u, v, loss), new tables in the dtype of u."""
    rows = Rows([(torch.arange(u.shape[0], device=u.device), u),
                 (torch.arange(v.shape[0], device=v.device), v)], u.dtype)
    loss = step(rows, slab_tokens, slab_sents, shrink, negs, alpha, hp,
                **kw)
    return rows.leaves[0], rows.leaves[1], loss


def chunk(u: torch.Tensor, v: torch.Tensor, tokens: torch.Tensor,
          sents: torch.Tensor, base0: int, shrinks: torch.Tensor,
          negs: torch.Tensor, alphas, hp: Bound):
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


def word_vectors(u: torch.Tensor, hp: Bound, bitlevel: int) -> torch.Tensor:
    """Every word's vector: the mean of its quantized G_w rows."""
    V = hp.offsets.numel() - 1
    seg, sub = center_subwords(hp, torch.arange(V, device=u.device))
    q = quantize(u[sub].float(), bitlevel)
    out = torch.zeros((V, u.shape[1]), dtype=torch.float32, device=u.device)
    out.index_add_(0, seg, q)
    return out / torch.bincount(seg, minlength=V).float()[:, None]
