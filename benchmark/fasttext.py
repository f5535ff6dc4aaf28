"""The model module of fastText's subword skip-gram (Bojanowski et al.
2017, arXiv 1607.04606, the `fasttext skipgram` command; the program's
`-model fasttext`): its plain reference step in plain PyTorch, the
vocabulary's spelled words, each word's subword rows, the leaves, the
rows a step touches, the draw distribution and the work a step needs.  A
configuration whose `reference` key names this file is checked and
counted by it (benchmark/cells.py; the contract, its optional pieces
included, is in benchmark/README.md and benchmark/hooks.py).

Imports torch, numpy and the benchmark's model-free parts
(benchmark/plain.py) only: nothing of the program under test, of JAX or
of the JAX package.  The step is a copy of tests/plain_fasttext.py `step`
on plain.py's quantizer, sigmoids and `Rows`, held bit for bit equal to
it by benchmark/tests/test_bench_fasttext.py.

- `vocab_words`: `</s>`, then word r (r = 1, 2, ...) spelled from the
  configuration alone: a numeral over SYLLABLES (700 syllables, 100 of
  two letters, consonant and vowel, then 600 with one of six codas), of
  one syllable for the 700 most frequent words, two for the next 490,000
  and three after, so frequent words are short and rare ones long; the
  j-th word of a length is the numeral of j * P mod 700^k (P odd and
  prime to 700: MIX mod 700^k, raised to the next such), so words of one
  length spread over the syllables' combinations and share n-grams as a
  language's words do;
- `bind`: each word's subword rows G_w, its own row, then one row
  V + fnv1a(g) % bucket per n-gram g of minn..maxn bytes of `<word>` (by
  start, then by length, duplicates kept, a lone `<` or `>` never one),
  fastText's 32-bit FNV-1a with each byte sign-extended as its int8;
  `</s>` its own row only.  Built on the device in blocks of words, each
  block a [words, bytes] matrix of `<word>`s and one pass per n-gram
  length over all of its starts: a CSR (`offsets`, `ids`) and each
  word's |G_w| on the host;
- `leaves`: the program's two tables as they are, input rows
  [V + buckets, D] and output rows [V, D];
- `touched`: input rows, the centers' G_w; output rows, the slab's
  words (the pairs' targets) and the negatives;
- `negative_probs`: count^0.5 (fastText's negatives table), with the
  mass of `</s>` spread evenly over ids 1..V-1, as the program's draw
  remaps a drawn 0;
- `step`: per center h = the mean of its quantized G_w rows; each
  (center, context) pair scores the context's output row, and K
  negatives drawn for that pair (pair-major, [B, 2W*K] a step; one equal
  to the context skipped), against h, on the Word2Bits contract
  (quantized reads, the table sigmoid in the gradient, the exact one in
  the loss, 2*alpha*reg decay a visit); each output row gets g * h, and
  the center's gradient for h, summed over its pairs, is added whole to
  every row of G_w.  Departures, as in the program: a synchronous
  minibatch of B centers from the rows as they were before the step;
  masked pairs' draws masked, not left undrawn; each row's updates summed
  in float32 and added once a step.  Computed in blocks of BLOCK centers,
  so that at the published widths (D 300, W 5, K 5, B 8192) no
  intermediate exceeds [512, 10, 6, 300];
- `step_flops`, `step_bytes`: from each word's |G_w| in the bound state
  under the subsampled stream's distribution.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from benchmark.plain import EDGE_TOL, MAX_EXP, Rows, quantize, \
    sigmoid_exact, sigmoid_lut, store

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODELS = ("fasttext",)
BLOCK = 512
BIND_WORDS = 1 << 18             # words a block of `bind`
EOS = "</s>"
CONSONANTS = "bcdfghjklmnprstvwxyz"
VOWELS = "aeiou"
CODAS = "nrsltk"
SYLLABLES = tuple([c + v for c in CONSONANTS for v in VOWELS]
                  + [c + v + k for c in CONSONANTS for v in VOWELS
                     for k in CODAS])
MIX = 2654435761


@dataclass(frozen=True)
class Hyper:
    bitlevel: int
    size: int
    window: int
    negative: int
    batch: int
    minn: int
    maxn: int
    bucket: int
    reg: float = 0.0


@dataclass
class Bound:
    """`bind`'s state: the widths and each word's subword rows."""
    hyper: Hyper
    offsets: torch.Tensor   # int64 [V + 1] on the device
    ids: torch.Tensor       # int64 [offsets[-1]]: G_w of each word in turn
    n_sub: np.ndarray       # int64 [V]: |G_w|, on the host


def hyper(cfg) -> Hyper:
    """The step's hyperparameters from the program's configuration."""
    return Hyper(bitlevel=cfg.bitlevel, size=cfg.size, window=cfg.window,
                 negative=cfg.negative, batch=cfg.batch_size, minn=cfg.minn,
                 maxn=cfg.maxn, bucket=cfg.bucket, reg=cfg.reg)


def negative_shape(cfg, S: int) -> tuple:
    """The negatives of one chunk call of S steps: [S, B, 2W*K]."""
    return (S, cfg.batch_size, 2 * cfg.window * cfg.negative)


def _multiplier(M: int) -> int:
    P = MIX % M
    while math.gcd(P, M) != 1:
        P += 1
    return P


def vocab_words(spec, n_types: int) -> List[str]:
    """`</s>` and the n_types - 1 spelled words (see the module's doc)."""
    N = len(SYLLABLES)
    words = [EOS] + list(SYLLABLES[:n_types - 1])
    k = 2
    while len(words) < n_types:
        M = N ** k
        m = min(M, n_types - len(words))
        x = np.arange(m, dtype=np.int64) * _multiplier(M) % M
        digits = []
        for _ in range(k):
            digits.append((x % N).tolist())
            x //= N
        words += ["".join(SYLLABLES[d] for d in reversed(ds))
                  for ds in zip(*digits)]
        k += 1
    return words


def _hash_step(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One byte of FNV-1a (b sign-extended as int8), on int64 < 2^32."""
    return ((h ^ torch.where(b > 127, b | 0xFFFFFF00, b)) * 16777619) \
        & 0xFFFFFFFF


def bind(cfg, words: List[str], device) -> Bound:
    """Each word's subword rows (see the module's doc) for the program's
    configuration `cfg` and the run's words."""
    hp = hyper(cfg)
    V = len(words)
    minn, maxn, nb = hp.minn, hp.maxn, hp.bucket
    ids, lens = [], []
    for w0 in range(0, V, BIND_WORDS):
        block = words[w0:w0 + BIND_WORDS]
        raw = [("<" + w + ">").encode("utf-8", "surrogateescape")
               for w in block]
        L = torch.tensor([len(r) for r in raw], device=device)
        width = int(L.max()) + max(maxn, 1)
        mat = np.zeros((len(block), width), np.int64)
        flat = np.frombuffer(b"".join(raw), np.uint8)
        row = np.repeat(np.arange(len(block)), [len(r) for r in raw])
        col = np.arange(flat.size) - np.repeat(
            np.cumsum([0] + [len(r) for r in raw[:-1]]), [len(r) for r in raw])
        mat[row, col] = flat
        M = torch.from_numpy(mat).to(device)
        n_w = M.shape[0]
        own = torch.arange(w0, w0 + n_w, device=device)[:, None]
        eos = torch.tensor([w == EOS for w in block], device=device)
        starts = torch.arange(width, device=device)[None, :]
        h = torch.full(M.shape, 2166136261, dtype=torch.int64, device=device)
        grams, keep = [], []
        for n in range(1, maxn + 1):
            shifted = torch.zeros_like(M)
            shifted[:, :width - n + 1] = M[:, n - 1:]
            h = _hash_step(h, shifted)
            if n >= minn:
                ok = (starts + n <= L[:, None]) & ~eos[:, None]
                if n == 1:
                    ok &= (starts > 0) & (starts + 1 < L[:, None])
                grams.append(V + h % nb)
                keep.append(ok)
        if grams:
            # per word: its own row, then by start and then by length
            g = torch.stack(grams, dim=2).reshape(n_w, -1)
            k = torch.stack(keep, dim=2).reshape(n_w, -1)
        else:
            g = torch.zeros((n_w, 0), dtype=torch.int64, device=device)
            k = torch.zeros((n_w, 0), dtype=torch.bool, device=device)
        sel = torch.cat([own, g], dim=1)
        ok = torch.cat([torch.ones_like(own, dtype=torch.bool), k], dim=1)
        ids.append(sel[ok])
        lens.append(ok.sum(dim=1))
    n_sub = torch.cat(lens)
    offsets = torch.zeros(V + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(n_sub, 0)
    return Bound(hyper=hp, offsets=offsets, ids=torch.cat(ids),
                 n_sub=n_sub.cpu().numpy())


def center_subwords(state: Bound, centers: torch.Tensor):
    """(segment [N], ids [N]): the G_w rows of each center in turn."""
    lens = state.offsets[centers + 1] - state.offsets[centers]
    seg = torch.repeat_interleave(torch.arange(centers.numel(),
                                               device=centers.device), lens)
    first = torch.repeat_interleave(state.offsets[centers], lens)
    within = torch.arange(seg.numel(), device=centers.device) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    return seg, state.ids[first + within]


def leaves(tables, cfg) -> List[torch.Tensor]:
    """The input rows [V + buckets, D] and the output rows [V, D]."""
    inp, out = tables
    buckets = cfg.bucket if cfg.maxn else 0
    if inp.shape[0] != out.shape[0] + buckets:
        raise ValueError(f"input rows {inp.shape[0]}, output rows "
                         f"{out.shape[0]}: not V + {buckets} and V")
    return [inp, out]


def touched(state: Bound, slab_tokens: torch.Tensor, negs: torch.Tensor):
    W, B = state.hyper.window, state.hyper.batch
    slab = slab_tokens.clamp_min(0)
    _, sub = center_subwords(state, slab[W:W + B])
    return [torch.unique(sub),
            torch.unique(torch.cat([slab, negs.reshape(-1)]))]


def negative_probs(counts: np.ndarray) -> np.ndarray:
    """count^0.5, the mass of `</s>` spread over ids 1..V-1."""
    w = counts.astype(np.float64) ** 0.5
    p = w / w.sum()
    p0 = p[0]
    p[0] = 0.0
    p[1:] += p0 / (len(p) - 1)
    return p


def step(rows: Rows, slab_tokens: torch.Tensor, slab_sents: torch.Tensor,
         shrink: torch.Tensor, negs: torch.Tensor, alpha: float, hp: Bound,
         compute: torch.dtype = torch.float32, half: bool = False,
         block: int = BLOCK) -> torch.Tensor:
    """One synchronous step over the B centers at slab positions W..W+B-1
    (slab_tokens, slab_sents [B+2W], -1 padding; shrink [B]; negs
    [B, 2W*K]) on `rows` (leaf 0 input rows, leaf 1 output rows) in
    place; returns the step's loss (float32) and leaves in
    rows.loss_bounds the least and the most it can be when the scores at
    exactly +-6 fall on either side of the saturation.  `compute` is the
    arithmetic's precision; `half` keeps only the first B/2 centers and
    doubles the rate.  Computed in blocks of `block` centers; every update
    is summed per row in float32 over the step."""
    h_ = hp.hyper
    B, W, D, K, bl = h_.batch, h_.window, h_.size, h_.negative, h_.bitlevel
    dev = rows.leaves[0].device
    a = torch.tensor(alpha * (2.0 if half else 1.0), dtype=torch.float32,
                     device=dev).to(compute)
    two_ar = 2.0 * a * h_.reg
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
        if h_.reg:
            in_sq = torch.zeros((n,), dtype=compute, device=dev)
            in_sq.index_add_(0, seg, (q_sub * q_sub).sum(dim=-1))
            rg = h_.reg * ((q_t * q_t).sum(dim=-1) + label
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
        if h_.reg:
            dv = dv - two_ar * x_t * dm[..., None]
            du = du - two_ar * m.sum(dim=1)[seg][:, None] * x_sub
        acc_in.index_add_(0, r_sub, du.float())
        acc_out.index_add_(0, r_t.reshape(-1), dv.reshape(-1, D).float())
    scale = 2.0 if half else 1.0
    rows.loss_bounds = (float(lo) * scale, float(hi) * scale)
    rows.leaves = [store(x_in_all.float() + acc_in, rows.storage),
                   store(x_out_all.float() + acc_out, rows.storage)]
    return (loss * scale).float()


def mean_subwords(shape) -> float:
    """E|G_w| over a word of the subsampled stream."""
    return float((shape.p_kept * shape.state.n_sub).sum())


def step_flops(shape) -> float:
    """Per center: the gather-mean's adds and the scatter's adds over its
    |G_w| rows, D each; per pair (2W a center) and target (the context and
    its K negatives): the dot product, h's gradient term and the output
    row, each 2D operations; the context rows' sums by slab position; the
    output scatter's adds (B+2W slab rows and the negatives')."""
    B, W, D, K = shape.B, shape.W, shape.D, shape.K
    pairs = B * 2 * W
    adds = (shape.n_slab + shape.n_negs) * D
    return (2.0 * B * mean_subwords(shape) * D + 6.0 * pairs * (K + 1) * D
            + pairs * D + adds)


def step_bytes(shape) -> float:
    """Each center's |G_w| input rows (as gathered: an upper bound of the
    distinct rows) and each touched output row (the slab's words and the
    negatives) read and written once."""
    rows_in = shape.B * mean_subwords(shape)
    return 2.0 * (rows_in + shape.rows_all) * shape.D * shape.elt
