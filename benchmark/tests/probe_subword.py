"""A model module for the hook tests (test_bench_hooks.py): a miniature
subword skip-gram, fastText's (Bojanowski et al. 2017, arXiv 1607.04606;
the `fasttext skipgram` command), in plain torch.  It gives every
optional piece of the contract (benchmark/hooks.py), as a subword
configuration would:

- `vocab_words`: spelled words made from the configuration: word i is
  the bijective base-8 numeral of i in two-letter syllables ("ka", "ri",
  ..., "kaka", ...), so words share n-grams as a language's do;
- `bind`: each word's subword rows, G_w: its own row, then one row per
  n-gram of 3-6 bytes of `<word>`, FNV-1a hashed (fastText's `hash`)
  into V + hash % BUCKETS; a CSR (`offsets` [V+1], `ids`) on the device
  and each word's |G_w| on the host; `</s>` has its own row only;
- `leaves`: the program's two tables as they are: input rows
  [V + BUCKETS, D] (words, then buckets) and output rows [V, D];
- `touched`: input rows, the centers' G_w; output rows, the slab's words
  (the pairs' targets) and the negatives;
- `negative_probs`: count^0.5 (fastText's negative table), with the mass
  of `</s>` spread evenly over ids 1..V-1 (as plain.negative_probs does
  with count^0.75, so that plain.draw_negatives never draws id 0);
- `step`: per center h = mean of its G_w rows; each (center, context)
  pair scores the context's output row against h, with K negatives drawn
  for that pair (a negative equal to the context skipped); the center's
  whole hidden gradient, summed over its pairs, is added to every row of
  G_w.  Float32, unquantized, the exact sigmoid; a synchronous minibatch
  with each row's updates summed in float32 and added once a step, as
  the other model modules;
- `step_flops`, `step_bytes`: from each word's |G_w| in the bound state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.plain import Rows, store

MODELS = ("skipgram",)
MINN, MAXN, BUCKETS = 3, 6, 1024
SYLLABLES = ("ka", "ri", "to", "ne", "su", "mo", "la", "pe")


@dataclass(frozen=True)
class Hyper:
    size: int
    window: int
    negative: int
    batch: int


@dataclass
class Bound:
    """`bind`'s state: the widths and each word's subword rows."""
    hyper: Hyper
    offsets: torch.Tensor   # int64 [V + 1]
    ids: torch.Tensor       # int64 [offsets[-1]]: G_w of each word in turn
    n_sub: np.ndarray       # int64 [V]: |G_w|


def hyper(cfg) -> Hyper:
    return Hyper(size=cfg.size, window=cfg.window, negative=cfg.negative,
                 batch=cfg.batch_size)


def negative_shape(cfg, S: int) -> tuple:
    """Per pair, as skipgram.py: [S, B, 2W*K]."""
    return (S, cfg.batch_size, 2 * cfg.window * cfg.negative)


def vocab_words(spec, n_types: int):
    words = ["</s>"]
    for i in range(1, n_types):
        digits = []
        while i:
            i, r = divmod(i - 1, len(SYLLABLES))
            digits.append(SYLLABLES[r])
        words.append("".join(reversed(digits)))
    return words


def fnv1a(data: bytes) -> int:
    """fastText's 32-bit FNV-1a (each byte sign-extended, as its int8)."""
    h = 2166136261
    for b in data:
        h = ((h ^ ((b - 256 if b > 127 else b) & 0xFFFFFFFF))
             * 16777619) & 0xFFFFFFFF
    return h


def subwords(word: str, i: int, V: int):
    """G_w of word i: i, then its n-grams' bucket rows."""
    if word == "</s>":
        return [i]
    b = ("<" + word + ">").encode()
    return [i] + [V + fnv1a(b[s:s + n]) % BUCKETS
                  for s in range(len(b))
                  for n in range(MINN, MAXN + 1) if s + n <= len(b)]


def bind(cfg, words, device) -> Bound:
    V = len(words)
    groups = [subwords(w, i, V) for i, w in enumerate(words)]
    n_sub = np.array([len(g) for g in groups], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(n_sub)])
    ids = np.concatenate([np.asarray(g, np.int64) for g in groups])
    return Bound(hyper=hyper(cfg),
                 offsets=torch.from_numpy(offsets).to(device),
                 ids=torch.from_numpy(ids).to(device), n_sub=n_sub)


def center_subwords(state: Bound, centers: torch.Tensor):
    """(segment [N], ids [N]): the G_w rows of each center in turn."""
    lens = state.offsets[centers + 1] - state.offsets[centers]
    seg = torch.repeat_interleave(torch.arange(centers.numel(),
                                               device=centers.device), lens)
    first = torch.repeat_interleave(state.offsets[centers], lens)
    within = torch.arange(seg.numel(), device=centers.device) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    return seg, state.ids[first + within]


def leaves(tables, cfg):
    inp, out = tables
    if inp.shape[0] != out.shape[0] + BUCKETS:
        raise ValueError(f"input rows {inp.shape[0]}, output rows "
                         f"{out.shape[0]}: not V + {BUCKETS} and V")
    return [inp, out]


def touched(state: Bound, slab_tokens: torch.Tensor, negs: torch.Tensor):
    W, B = state.hyper.window, state.hyper.batch
    slab = slab_tokens.clamp_min(0)
    _, sub = center_subwords(state, slab[W:W + B])
    return [torch.unique(sub),
            torch.unique(torch.cat([slab, negs.reshape(-1)]))]


def negative_probs(counts: np.ndarray) -> np.ndarray:
    w = counts.astype(np.float64) ** 0.5
    p = w / w.sum()
    p0 = p[0]
    p[0] = 0.0
    p[1:] += p0 / (len(p) - 1)
    return p


def step(rows: Rows, slab_tokens: torch.Tensor, slab_sents: torch.Tensor,
         shrink: torch.Tensor, negs: torch.Tensor, alpha: float, hp: Bound,
         compute: torch.dtype = torch.float32,
         half: bool = False) -> torch.Tensor:
    """One synchronous step over the B centers at slab positions W..W+B-1
    on `rows` (leaf 0 input rows, leaf 1 output rows) in place; returns
    the step's loss (the pairs' log-likelihood, float32)."""
    h_ = hp.hyper
    B, W, D, K = h_.batch, h_.window, h_.size, h_.negative
    dev = rows.leaves[0].device
    a = alpha * (2.0 if half else 1.0)
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
    seg, sub = center_subwords(hp, centers)
    r_sub = rows.find(0, sub)
    n_sub = torch.bincount(seg, minlength=B).to(compute)
    hidden = torch.zeros((B, D), dtype=compute, device=dev)
    hidden.index_add_(0, seg, rows.leaves[0][r_sub].to(compute))
    hidden = hidden / n_sub[:, None]
    negs3 = negs.reshape(B, 2 * W, K)
    targets = torch.cat([ctx[..., None], negs3], dim=2)       # [B,2W,K+1]
    r_t = rows.find(1, targets)
    x_t = rows.leaves[1][r_t].to(compute)                     # [..., D]
    f = torch.matmul(x_t, hidden[:, None, :, None])[..., 0]
    label = torch.zeros_like(f)
    label[..., 0] = 1.0
    eligible = torch.cat(
        [torch.ones((B, 2 * W, 1), dtype=torch.bool, device=dev),
         negs3 != ctx[..., None]], dim=2)
    dm = (eligible & mask[..., None]).to(compute)
    g = (label - torch.sigmoid(f)) * a * dm
    signed = torch.where(label > 0, f, -f).float()
    loss = (torch.nn.functional.logsigmoid(signed) * dm.float()).sum()
    grad_h = (g[..., None] * x_t).sum(dim=(1, 2))             # [B, D]
    dv = g[..., None] * hidden[:, None, None, :]              # [.., K+1, D]
    acc_in = torch.zeros(rows.leaves[0].shape, dtype=torch.float32,
                         device=dev)
    acc_out = torch.zeros(rows.leaves[1].shape, dtype=torch.float32,
                          device=dev)
    acc_in.index_add_(0, r_sub, grad_h[seg].float())
    acc_out.index_add_(0, r_t.reshape(-1), dv.reshape(-1, D).float())
    rows.leaves[0] = store(rows.leaves[0].float() + acc_in, rows.storage)
    rows.leaves[1] = store(rows.leaves[1].float() + acc_out, rows.storage)
    scale = 2.0 if half else 1.0
    rows.loss_bounds = (float(loss) * scale, float(loss) * scale)
    return (loss * scale).float()


def mean_subwords(shape) -> float:
    """E|G_w| over a word of the subsampled stream."""
    return float((shape.p_kept * shape.state.n_sub).sum())


def step_flops(shape) -> float:
    """Per center: the mean of |G_w| rows and the hidden gradient added
    to each, D operations a row; per pair and target (the context and K
    negatives): the dot product, the hidden gradient's term and the
    output row's, each 2D operations, and the output row's add."""
    B, W, D, K = shape.B, shape.W, shape.D, shape.K
    pairs = B * 2 * W
    return 2.0 * B * mean_subwords(shape) * D + 7.0 * pairs * (K + 1) * D


def step_bytes(shape) -> float:
    """Each center's |G_w| input rows (as gathered, an upper bound of the
    distinct rows) and each touched output row (the slab's words and the
    negatives) read and written once."""
    rows_in = shape.B * mean_subwords(shape)
    return 2.0 * (rows_in + shape.rows_all) * shape.D * shape.elt
