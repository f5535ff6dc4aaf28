"""The comparison that decides `correct`, run once the window has closed.

The window is one `train.train` call: it builds its tables, epochs and
negatives inside and returns the trained tables.  Bitlevel-1 training is
chaotic in the signs (runs whose sums differ in the last bits part within
about 20 steps), so no reference can follow a whole epoch.  The check
therefore follows the program from its own state, the window's trained
tables, one step at a time, and checks by themselves the stages that this
skips:

- `step_readings`: whole chunk calls of the window's own chunk callable,
  at the timed batch and the cell's steps per chunk, with the scalars of
  the window's middle chunk call (its offset and learning-rate decay), on
  the window's tables.  In each call one step (the first, the middle,
  the last) holds B real centers and every other step only padding, so
  the compared step runs through that step's slab offset, its share of
  the chunk's hoisted scatter plan and its decayed rate.  Shrinks come
  from the check's generator and negatives from the reference's own
  draws (plain.draw_negatives) from the model's draw distribution, in
  the shape the cell's model module gives (`negative_shape`).  That
  module's plain step (`step`; CBOW's is reference.py) takes each
  compared step from the same rows: those it names (`touched`) of each
  of its leaves (`leaves`; hooks.py has both and their defaults).  Read,
  worst over the compared steps: the step's loss (`loss_gap`), the
  touched rows element by element, per leaf (`rows_gap`) and the change
  of each whole leaf (`delta_gap`, the gap of the change norms);
- `sampler_tv`: the window's alias table against the model's draw
  distribution (unigram^0.75 by default), over equal-mass bins of words;
- `epoch_errors`: the window's last epoch arrays against the corpus
  (layout, sentence ids, per-word kept counts, the order of the words that
  are never subsampled, the number kept);
- `schedule_errors`: every chunk call of the window (recorded by tap.py)
  against the schedule the benchmark works out itself: steps, offsets,
  learning-rate scalars, epochs, the table handed on;
- `finite_errors`: the returned tables and chunk losses are finite.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark import hooks, plain

BLOCK_ROWS = 1 << 16
TV_BINS = 256
TV_DRAWS = 1 << 24


def _delta_norms(now, start) -> List[float]:
    """Per leaf, the norm of now - start, in float32, in row blocks."""
    out = []
    for a, b in zip(now, start):
        sq = 0.0
        for r0 in range(0, a.shape[0], BLOCK_ROWS):
            d = a[r0:r0 + BLOCK_ROWS].float() - b[r0:r0 + BLOCK_ROWS].float()
            sq += float((d * d).sum())
        out.append(math.sqrt(sq))
    return out


def _row_norms(now: plain.Rows, start: plain.Rows) -> List[float]:
    """Per leaf, the norm of the rows' change."""
    return [float((a.float() - b.float()).norm())
            for a, b in zip(now.leaves, start.leaves)]


LOWER = {torch.float32: torch.bfloat16,
         torch.bfloat16: torch.float8_e4m3fn}


def check_seed(seed: int) -> int:
    """The check's own generator seed, apart from the program's."""
    return int(np.random.SeedSequence([int(seed), 0x636865636B])
               .generate_state(1, np.uint64)[0] >> 1)


def compared_steps(S: int) -> List[int]:
    """The steps of a chunk that the check compares."""
    return sorted({0, S // 2, S - 1})


def middle_scalars(calls) -> tuple:
    """The scalars of the window's middle chunk call (tap.Call)."""
    real = [c for c in calls if not c.injected]
    return real[len(real) // 2].scalars


def step_readings(model, cfg, chunk_fn, alias, tables, corpus, seed: int,
                  scalars: tuple, mode: str = "program",
                  state=None) -> Dict[str, object]:
    """Compare the program (`mode` "program") or, in its place, the
    reference one precision lower ("control") with the reference, the step
    of the cell's model module `model`, over the steps `compared_steps`
    picks (see the module's doc), each a chunk call of its own from the
    program's state; `scalars` are a chunk call's (base0, alpha0,
    wca_start, wca_per_step, denom).  `state` is the module's `bind` of
    the run's words (hooks.py); None binds it on the default words
    (hooks.bound).  Leaves, touched rows and the draw distribution are the
    module's (hooks.py).  Returns the worst gaps (`loss_gap`, `rows_gap`,
    `delta_gap`) and, for the record, each step's.  The program's tables
    are changed in place."""
    from word2bits_tpu_torch.models.cbow import ChunkScalars

    B, W = cfg.batch_size, cfg.window
    S = cfg.steps_per_chunk
    dev = tables[0].device
    storage = getattr(torch, cfg.dtype)
    hp = (hooks.bound(model, cfg, dev, corpus.size) if state is None
          else state)
    leaves = hooks.of(model, "leaves")
    touched = hooks.of(model, "touched")
    base0, alpha0, wca0, wps, denom = scalars
    at = compared_steps(S)
    gen = torch.Generator(device=dev).manual_seed(check_seed(seed))
    keep = torch.from_numpy(plain.keep_probs(
        corpus.counts, cfg.sample, corpus.train_words).astype(np.float32)
    ).to(dev)
    enc = corpus.encoded_dev.to(dev)
    uni = torch.rand(enc.shape, generator=gen, device=dev)
    words, wsents = plain.slab_arrays(enc, keep, uni, W, len(at) * B)
    del uni
    cdf = plain.negative_cdf(corpus.counts, dev,
                             hooks.of(model, "negative_probs"))
    n = base0 + S * B + W
    full0 = None
    if mode == "program":
        full0 = [t.clone() for t in leaves(tables, cfg)]
    elif mode != "control":
        raise ValueError(f"unknown mode {mode!r}")

    def rows_at(ids, tabs, dtype):
        leaf = leaves(tabs, cfg)
        if len(ids) != len(leaf):
            raise ValueError(f"touched gives {len(ids)} id sets for "
                             f"{len(leaf)} leaves")
        return plain.Rows.of([(i, x[i]) for i, x in zip(ids, leaf)], dtype)

    gaps, raw, rows_gaps, delta_gaps, norms = [], [], [], [], []
    for k, s in enumerate(at):
        # the epoch arrays of one chunk: padding, and B centers at step s
        # (padding on either side, so no other step has a center)
        lo = base0 + s * B
        tokens = torch.full((n,), plain.PAD, dtype=torch.int32, device=dev)
        sents = torch.full((n,), plain.PAD, dtype=torch.int32, device=dev)
        tokens[lo:lo + B] = words[W + k * B:W + (k + 1) * B].int()
        sents[lo:lo + B] = wsents[W + k * B:W + (k + 1) * B].int()
        shrinks = torch.randint(0, W, (S, B), generator=gen, device=dev)
        negs = plain.draw_negatives(gen, cdf, model.negative_shape(cfg, S))
        t_slab = tokens[lo - W:lo + B + W].long()
        s_slab = sents[lo - W:lo + B + W].long()
        ids = touched(hp, t_slab, negs[s])
        start = rows_at(ids, tables, storage)
        rows = rows_at(ids, tables, storage)
        alpha = plain.step_alpha(alpha0, wca0 + s * wps, denom)
        ref_loss = float(model.step(rows, t_slab, s_slab, shrinks[s],
                                    negs[s], alpha, hp))
        lo_b, hi_b = rows.loss_bounds
        if mode == "program":
            sc = ChunkScalars(base0=base0, alpha0=alpha0, wca_start=wca0,
                              wca_per_step=wps, denom=denom)
            *tables, loss = chunk_fn(*tables, tokens, sents, alias, sc, None,
                                     n_steps=S, shrinks=shrinks, negs=negs)
            loss = float(loss)
            got = rows_at(ids, tables, storage)
            prog_norms = _delta_norms(leaves(tables, cfg), full0)
            for a, b in zip(full0, leaves(tables, cfg)):
                a.copy_(b)
        else:
            low = LOWER[storage]
            got = rows_at(ids, tables, low)
            cstart = rows_at(ids, tables, low)
            loss = float(model.step(got, t_slab, s_slab, shrinks[s],
                                    negs[s], alpha, hp,
                                    compute=torch.bfloat16))
            prog_norms = _row_norms(got, cstart)
        ref_norms = _row_norms(rows, start)
        # how far the program's loss lies outside what the reference's
        # can be with its scores at exactly +-6 on either side
        gaps.append(max(lo_b - loss, loss - hi_b, 0.0)
                    / max(abs(ref_loss), 1e-30))
        raw.append(abs(loss - ref_loss) / max(abs(ref_loss), 1e-30))
        rows_gaps.append(plain.rows_gap(got, rows, start))
        d = plain.leaf_gaps(prog_norms, ref_norms)
        delta_gaps.append(float("inf") if d is None else d)
        norms.append([prog_norms, ref_norms])
    del full0
    return {"loss_gap": max(gaps), "rows_gap": max(rows_gaps),
            "delta_gap": max(delta_gaps), "steps": at,
            "step_loss_gaps": gaps, "step_loss_raw": raw,
            "step_rows_gaps": rows_gaps, "step_delta_gaps": delta_gaps,
            "leaf_norms": norms}


def sampler_tv(alias, counts: np.ndarray, seed: int, draw=None,
               probs=plain.negative_probs) -> float:
    """Total variation, over TV_BINS bins of words of equal reference
    mass, between TV_DRAWS negatives drawn through the program's sampler
    (`draw`, default word2bits_tpu_torch.sampling.unigram.draw_negatives)
    from the window's alias table and the reference's distribution
    `probs(counts)` (the model module's `negative_probs`, hooks.py)."""
    if draw is None:
        from word2bits_tpu_torch.sampling.unigram import draw_negatives
        draw = draw_negatives
    dev = alias.prob.device
    V = len(counts)
    p = probs(counts)
    order = np.argsort(-p, kind="stable")
    cum = np.concatenate([[0.0], np.cumsum(p[order])[:-1]])
    bins = np.empty(V, np.int64)
    bins[order] = np.minimum((cum * TV_BINS).astype(np.int64), TV_BINS - 1)
    want = np.bincount(bins, weights=p, minlength=TV_BINS)
    gen = torch.Generator(device=dev).manual_seed(check_seed(seed) + 1)
    got = torch.bincount(draw(gen, alias, (TV_DRAWS,), V).reshape(-1),
                         minlength=V).cpu().numpy()
    have = np.bincount(bins, weights=got, minlength=TV_BINS) / TV_DRAWS
    return 0.5 * float(np.abs(have - want).sum())


def capacity(cfg, n_tokens: int) -> int:
    """The epoch arrays' capacity (train.segment_capacity's formula)."""
    B, S = cfg.batch_size, cfg.steps_per_chunk
    seg = min(n_tokens, cfg.segment_tokens) or 1
    return ((seg + S * B + 8 + 1023) // 1024) * 1024


def epoch_errors(cfg, tokens: torch.Tensor, sents: torch.Tensor,
                 corpus) -> int:
    """Faults of the window's newest epoch arrays against the corpus."""
    W = cfg.window
    dev = tokens.device
    V = corpus.size
    enc = corpus.encoded_dev.to(dev).long()
    errors = 0
    cap = capacity(cfg, len(corpus.encoded))
    if tokens.numel() != cap + 2 * W or sents.numel() != tokens.numel():
        return 1
    tok, sen = tokens.long(), sents.long()
    n = int((tok[W:W + cap] >= 0).sum())
    body, sb = tok[W:W + n], sen[W:W + n]
    pad = torch.cat([tok[:W], tok[W + n:]])
    spad = torch.cat([sen[:W], sen[W + n:]])
    errors += int((pad != plain.PAD).sum()) + int((spad != plain.PAD).sum())
    errors += int(((body < 1) | (body >= V)).sum())
    if n == 0:
        return errors + 1
    # sentence ids: from 0, steps of 0 or 1, at most 1000 words each
    d = sb[1:] - sb[:-1]
    errors += int(sb[0] != 0) + int(((d != 0) & (d != 1)).sum())
    runs = torch.unique_consecutive(sb, return_counts=True)[1]
    errors += int((runs > plain.MAX_SENTENCE_LENGTH).sum())
    if corpus.counts[0] == 0:
        # one line: the sentences are the 1000-word cuts exactly
        cut = torch.arange(n, device=dev) // plain.MAX_SENTENCE_LENGTH
        errors += int((sb != cut).sum())
    # per word: never more than the corpus holds, all of it where the
    # keep probability is 1 or more
    keep = plain.keep_probs(corpus.counts, cfg.sample, corpus.train_words)
    always = torch.from_numpy(keep.astype(np.float32) >= 1.0).to(dev)
    always[0] = False
    kept = torch.bincount(body.clamp(0, V - 1), minlength=V)
    have = torch.from_numpy(corpus.counts).to(dev)
    errors += int((kept > have).sum()) + int((always & (kept != have)).sum())
    # the words that are never subsampled, in corpus order, with their
    # sentence breaks
    a_corpus = always[enc]
    raw = torch.cumsum((enc == 0).long(), 0)[a_corpus]
    a_seq = enc[a_corpus]
    a_kept = always[body]
    if int(a_kept.sum()) != a_seq.numel():
        errors += 1
    else:
        errors += int((body[a_kept] != a_seq).sum())
        s_a = sb[a_kept]
        errors += int(((raw[1:] != raw[:-1]) & (s_a[1:] == s_a[:-1])).sum())
    # the number kept, within 8 standard deviations of its expectation
    mean, sd = plain.kept_stats(corpus.counts, cfg.sample, corpus.train_words)
    errors += int(abs(n - mean) > 8 * sd + 1)
    return errors


def schedule_errors(cfg, calls, corpus, n_last: int, epochs: int) -> int:
    """Faults of the window's chunk calls against the schedule the
    benchmark works out from the corpus and the flags: `epochs` whole
    epochs; n_last is the kept words of the newest epoch arrays."""
    B, S, W = cfg.batch_size, cfg.steps_per_chunk, cfg.window
    T = corpus.train_words
    denom = float(cfg.iter) * T + 1.0
    if len(corpus.encoded) > cfg.segment_tokens:
        return 1    # one segment an epoch is all this check knows
    calls = [c for c in calls if not c.injected]
    errors = 0
    starts = [i for i, c in enumerate(calls) if c.scalars[0] == W]
    if not starts or starts[0] != 0:
        return 1
    bounds = starts + [len(calls)]
    n_epochs = len(starts)
    errors += int(n_epochs != epochs)
    for e in range(n_epochs):
        ec = calls[bounds[e]:bounds[e + 1]]
        wps = ec[0].scalars[3]
        n_f = B * float(T) / wps if wps > 0 else -1.0
        n_e = round(n_f)
        if n_e <= 0 or abs(n_f - n_e) > 1e-6 * n_e:
            errors += 1
            continue
        if e == n_epochs - 1 and n_e != n_last:
            errors += 1
        n_steps = math.ceil(n_e / B)
        want = [min(S, n_steps - ci * S)
                for ci in range(max(1, math.ceil(n_steps / S)))]
        words = float(e * T)
        if len(ec) != len(want):
            errors += 1
            continue
        for ci, (c, k) in enumerate(zip(ec, want)):
            base0, a0, wca0, wps_c, den = c.scalars
            ok = (c.n_steps == max(k, 1) and base0 == W + ci * S * B
                  and a0 == cfg.effective_alpha and wps_c == wps
                  and den == denom
                  and abs(wca0 - words) <= 1e-12 * max(words, 1.0))
            errors += int(not ok)
            words += k * wps
        if len({c.tokens_id for c in ec}) != 1:
            errors += 1
    for a, b in zip(calls, calls[1:]):
        errors += int(b.table_in != a.table_out)
    return errors


def finite_errors(tables, chunk_losses) -> int:
    bad = sum(not math.isfinite(x) for x in chunk_losses)
    for t in tables:
        for r0 in range(0, t.shape[0], BLOCK_ROWS):
            bad += int(not bool(torch.isfinite(t[r0:r0 + BLOCK_ROWS]).all()))
    return bad


def judge(limits: Dict[str, float], got: Dict[str, float]):
    """(checks, correct, failed): each number a cell's limits name, beside
    its limit; correct when every one is finite and within it."""
    checks = {k: [got[k], lim] for k, lim in limits.items()}
    bad = sum(not (math.isfinite(v) and v <= lim)
              for v, lim in checks.values())
    return checks, bad == 0, bad
