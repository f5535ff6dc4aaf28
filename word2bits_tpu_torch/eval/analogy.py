"""Google-analogies evaluator: the reference's O(Q*V*D) scalar scan
(reference src/compute-accuracy.c:63-189) as blocked matrix products.

Per question a:b::c:d the reference computes vec = M[b] - M[a] + M[c] over
L2-normalized (optionally re-quantized) rows and takes the argmax dot
product over all rows except a, b, c (3COSADD, top-1).  Here a batch of
questions is a (Q, D) matrix, scored against the table in blocks of rows
(`vec @ blockᵀ`, torch.matmul: a plain large product, as the JAX package
left it to XLA) with a running masked argmax, so no (Q, V) score matrix is
ever held.  Semantics are those of the JAX package's eval/analogy.py:

  * vocabulary uppercased on load; duplicate uppercased words resolve to the
    lowest row, and a prediction on a case-duplicate of the answer counts
    (reference :104,140-145,178)
  * optional truncation to the top `threshold` rows (:86)
  * optional re-quantization of loaded rows with a CLI bitlevel (:106)
  * rows are L2-normalized after quantization (:107-110)
  * questions with any OOV word are skipped but counted (TQ vs TQS,
    :148-157)
  * best-distance starts at 0: a prediction counts only if its score is
    strictly positive (:115,167); ties go to the first row (first strictly
    greater, :166-176)
  * semantic = the first 5 sections, syntactic = the rest (:181-183)

The normalized table goes to the device once, in row blocks, and no
padded or widened copy of it is made there.  Above _BF16_TABLE_BYTES (the
JAX package's size rule) it is stored in bfloat16 and scored with float32
sums, as the JAX package does at the 3.7M x 800d configuration.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from word2bits_tpu_torch.ops.quantize import quantize_np

SEMANTIC_SECTIONS = 5  # reference QID <= 5 (src/compute-accuracy.c:181-183)

# Tables above this many bytes (float32, at the JAX package's padded size)
# are scored in bfloat16; module constant so tests can force the branch.
_BF16_TABLE_BYTES = 2 << 30
# host rows normalized and uploaded per block
_UPLOAD_ROWS = 1 << 16


@dataclass
class AnalogyQuestions:
    """Parsed questions-words.txt."""

    sections: List[str]                    # section names in order
    questions: List[Tuple[int, str, str, str, str]]  # (section_idx, a, b, c, d)


def parse_questions(lines: Iterable[str]) -> AnalogyQuestions:
    """": name" lines open sections; 4-word lines are questions, uppercased;
    anything else is skipped."""
    sections: List[str] = []
    questions: List[Tuple[int, str, str, str, str]] = []
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == ":":
            sections.append(parts[1] if len(parts) > 1 else "")
            continue
        if len(parts) != 4:
            continue
        a, b, c, d = (p.upper() for p in parts)
        questions.append((len(sections) - 1, a, b, c, d))
    return AnalogyQuestions(sections=sections, questions=questions)


def load_questions(path: str) -> AnalogyQuestions:
    with open(path, "r", encoding="utf-8") as f:
        return parse_questions(f)


@dataclass
class AnalogyResult:
    section_names: List[str]
    section_seen: np.ndarray      # int [S] — questions evaluated per section
    section_correct: np.ndarray   # int [S]
    total_questions: int          # TQ — all questions incl. OOV-skipped
    seen_questions: int           # TQS

    @property
    def total_accuracy(self) -> float:
        t = self.section_seen.sum()
        return float(self.section_correct.sum()) / t * 100 if t else 0.0

    def _acc(self, mask) -> float:
        t = self.section_seen[mask].sum()
        return float(self.section_correct[mask].sum()) / t * 100 if t else 0.0

    @property
    def semantic_accuracy(self) -> float:
        m = np.arange(len(self.section_names)) < SEMANTIC_SECTIONS
        return self._acc(m)

    @property
    def syntactic_accuracy(self) -> float:
        m = np.arange(len(self.section_names)) >= SEMANTIC_SECTIONS
        return self._acc(m)

    @property
    def coverage(self) -> float:
        return self.seen_questions / self.total_questions * 100 \
            if self.total_questions else 0.0


@dataclass
class AnalogyPredictions:
    """Per covered question: its resolved rows and the scorer's answer."""

    quads: np.ndarray          # int64 [n, 5] (section, a, b, c, d) rows
    canon: np.ndarray          # int64 [V] first row of each uppercased word
    best: np.ndarray           # int64 [n] predicted row
    best_score: np.ndarray     # float32 [n] its score (-inf: none)
    second_score: Optional[np.ndarray]  # float32 [n] runner-up (top2=True)
    total_questions: int

    @property
    def correct(self) -> np.ndarray:
        """bool [n]: a strictly positive best score on the answer's word."""
        return (self.best_score > 0.0) & (self.canon[self.best]
                                          == self.quads[:, 4])


def _v_block(V: int) -> int:
    """Rows scored per product (the JAX package's block)."""
    return min(32768, max(128, ((V + 127) // 128) * 128))


def _device_table(M: np.ndarray, bitlevel: int, device) -> torch.Tensor:
    """quantize, L2-normalize (host, numpy, in row blocks) and upload M:
    [V, D] float32, or bfloat16 above the size rule (the JAX package's
    table at its padded size)."""
    V, D = M.shape
    v_block = _v_block(V)
    padded = (V + (-V) % v_block) * (D + (-D) % 128) * 4
    dtype = torch.float32
    if padded > _BF16_TABLE_BYTES:
        print(f"analogy eval: table {padded / 1e9:.1f} GB > "
              f"{_BF16_TABLE_BYTES / 1e9:.0f} GB — scoring in bfloat16 "
              "(f32 accumulation); see eval/analogy.py",
              file=sys.stderr, flush=True)
        dtype = torch.bfloat16
    out = torch.empty((V, D), dtype=dtype, device=device)
    for r0 in range(0, V, _UPLOAD_ROWS):
        Mq = quantize_np(M[r0:r0 + _UPLOAD_ROWS], bitlevel)
        norm = np.sqrt((Mq * Mq).sum(axis=1, keepdims=True))
        with np.errstate(divide="ignore", invalid="ignore"):
            Mn = Mq / norm
        Mn[~np.isfinite(Mn)] = 0.0
        out[r0:r0 + Mn.shape[0]] = torch.from_numpy(Mn).to(device, dtype)
    return out


def score_questions(Mn: torch.Tensor, abc: torch.Tensor,
                    v_block: int = 32768, top2: bool = False):
    """(Q, 3) rows a, b, c -> best row [Q], best score [Q] (and the
    runner-up's score with top2) over all rows but a, b and c.

    vec = Mn[b] - Mn[a] + Mn[c] in the table's dtype; scores are float32
    sums (a bfloat16 table is widened one row block at a time).  Within a
    block the first maximum wins; across blocks an earlier block's winner
    survives ties: the reference's first-strictly-greater scan."""
    V = Mn.shape[0]
    Q = abc.shape[0]
    f32 = torch.float32
    vec = (Mn[abc[:, 1]] - Mn[abc[:, 0]] + Mn[abc[:, 2]]).to(f32)
    neg = float("-inf")
    best = torch.full((Q,), neg, dtype=f32, device=Mn.device)
    second = torch.full((Q,), neg, dtype=f32, device=Mn.device)
    besti = torch.zeros((Q,), dtype=torch.int64, device=Mn.device)
    for ofs in range(0, V, v_block):
        blk = Mn[ofs:ofs + v_block].to(f32)
        s = torch.matmul(vec, blk.T)                          # [Q, vb]
        gidx = torch.arange(ofs, ofs + blk.shape[0], device=Mn.device)
        excl = ((gidx[None, :] == abc[:, 0:1]) | (gidx[None, :] == abc[:, 1:2])
                | (gidx[None, :] == abc[:, 2:3]))
        s.masked_fill_(excl, neg)
        bi = torch.argmax(s, dim=1)
        bs = s.gather(1, bi[:, None])[:, 0]
        if top2:
            runner = s.scatter(1, bi[:, None], neg).amax(dim=1)
            second = torch.maximum(torch.minimum(bs, best),
                                   torch.maximum(second, runner))
        upd = bs > best
        best = torch.where(upd, bs, best)
        besti = torch.where(upd, gidx[bi], besti)
    return besti, best, (second if top2 else None)


def analogy_predictions(words: List[str], vectors: np.ndarray,
                        questions: AnalogyQuestions, bitlevel: int = 0,
                        threshold: int = 0, batch_size: int = 4096,
                        device=None, top2: bool = False
                        ) -> AnalogyPredictions:
    """Each covered question's predicted row (and score) on `device`
    (default cuda; pass device='cpu' for the CPU)."""
    from word2bits_tpu_torch.train import resolve_device
    device = resolve_device(device)
    M = np.asarray(vectors, dtype=np.float32)
    if threshold and M.shape[0] > threshold:
        M = M[:threshold]
        words = words[:threshold]

    # uppercase; first (most-frequent) row wins duplicates
    index: Dict[str, int] = {}
    for i, w in enumerate(words):
        index.setdefault(w.upper(), i)
    canon = np.asarray([index[w.upper()] for w in words], dtype=np.int64)

    tq = len(questions.questions)
    get = index.get
    quads = np.asarray(
        [(sec, get(a, -1), get(b, -1), get(c, -1), get(d, -1))
         for sec, a, b, c, d in questions.questions], dtype=np.int64
    ).reshape(tq, 5)
    covered = (quads[:, 1:] >= 0).all(axis=1) if tq else np.zeros(0, bool)
    res = quads[covered]
    n = res.shape[0]
    best = np.zeros(n, np.int64)
    best_score = np.zeros(n, np.float32)
    second = np.zeros(n, np.float32) if top2 else None
    if n:
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        Mn = _device_table(M, bitlevel, device)
        v_block = _v_block(M.shape[0])
        for ofs in range(0, n, batch_size):
            abc = torch.from_numpy(res[ofs:ofs + batch_size, 1:4]).to(device)
            bi, bs, sc = score_questions(Mn, abc, v_block, top2=top2)
            best[ofs:ofs + len(abc)] = bi.cpu().numpy()
            best_score[ofs:ofs + len(abc)] = bs.cpu().numpy()
            if top2:
                second[ofs:ofs + len(abc)] = sc.cpu().numpy()
        del Mn
    return AnalogyPredictions(quads=res, canon=canon, best=best,
                              best_score=best_score, second_score=second,
                              total_questions=tq)


def result_of(pred: AnalogyPredictions,
              section_names: List[str]) -> AnalogyResult:
    secs = pred.quads[:, 0]
    S = len(section_names)
    seen = np.bincount(secs, minlength=S).astype(np.int64)
    correct = np.bincount(secs[pred.correct], minlength=S).astype(np.int64)
    return AnalogyResult(section_names=list(section_names),
                         section_seen=seen, section_correct=correct,
                         total_questions=pred.total_questions,
                         seen_questions=int(seen.sum()))


def evaluate_analogies(words: List[str], vectors: np.ndarray,
                       questions: AnalogyQuestions, bitlevel: int = 0,
                       threshold: int = 0, batch_size: int = 4096,
                       device=None) -> AnalogyResult:
    """The reference compute_accuracy on `device` (default cuda; pass
    device='cpu' for the CPU)."""
    pred = analogy_predictions(words, vectors, questions, bitlevel=bitlevel,
                               threshold=threshold, batch_size=batch_size,
                               device=device)
    return result_of(pred, questions.sections)


def format_report(result: AnalogyResult) -> str:
    """Reproduce the reference's printf transcript
    (reference src/compute-accuracy.c:119-132,187) so outputs diff cleanly."""
    out: List[str] = []
    cacn = 0
    tacn = 0
    seac = sycn_c = 0
    secn = sycn = 0
    for s, name in enumerate(result.section_names):
        out.append(f"{name}:")
        ccn = int(result.section_correct[s])
        tcn = int(result.section_seen[s])
        cacn += ccn
        tacn += tcn
        if s < SEMANTIC_SECTIONS:
            seac += ccn
            secn += tcn
        else:
            sycn_c += ccn
            sycn += tcn
        tcn_p = tcn if tcn else 1  # reference: if TCN==0 TCN=1
        out.append(f"ACCURACY TOP1: {ccn / tcn_p * 100:.2f} %  ({ccn} / {tcn_p})")
        sem = seac / secn * 100 if secn else float("nan")
        syn = sycn_c / sycn * 100 if sycn else float("nan")
        tot = cacn / tacn * 100 if tacn else float("nan")
        out.append(
            f"Total accuracy: {tot:.2f} %   Semantic accuracy: {sem:.2f} %   "
            f"Syntactic accuracy: {syn:.2f} % ")
    cov = result.coverage
    out.append(
        f"Questions seen / total: {result.seen_questions} "
        f"{result.total_questions}   {cov:.2f} % ")
    return "\n".join(out)
