"""Structured synthetic corpus with learnable analogy relations.

The port's copy of the JAX package's data/structured.py (numpy only): the
same seed and sizes write byte-equal corpus and question files.  It stands
in for the text8 acceptance run: a corpus whose analogy structure is known
by construction, so a trained run's analogy accuracy can be held against
the JAX package's (word2bits_tpu_torch/tools/accuracy_parity.py).

Construction: a grid of composite entities w_{a,b} over two latent factors
(a in A, b in B).  Each sentence samples (a, b) and mixes factor-atom words
for a, for b, and the composite word.  CBOW then factorizes: the vector of
w_{a,b} approximates (vector of factor a) + (vector of factor b), so analogy
questions w_{a1,b1} : w_{a1,b2} :: w_{a2,b1} : w_{a2,b2} are solvable by
3COSADD — exactly what the Google-analogies evaluator measures.
"""

from __future__ import annotations

from typing import List

import numpy as np


def structured_corpus(path: str, questions_path: str,
                      na: int = 20, nb: int = 20,
                      n_sentences: int = 120_000,
                      n_questions: int = 1000,
                      seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    atoms_a = [[f"a{i}x{j}" for j in range(3)] for i in range(na)]
    atoms_b = [[f"b{i}x{j}" for j in range(3)] for i in range(nb)]
    composite = [[f"c{i}y{j}" for j in range(nb)] for i in range(na)]
    fillers = [f"f{i}" for i in range(20)]

    lines: List[str] = []
    for _ in range(n_sentences):
        a = rng.integers(na)
        b = rng.integers(nb)
        words: List[str] = []
        for _ in range(rng.integers(10, 18)):
            r = rng.random()
            if r < 0.3:
                words.append(atoms_a[a][rng.integers(3)])
            elif r < 0.6:
                words.append(atoms_b[b][rng.integers(3)])
            elif r < 0.85:
                words.append(composite[a][b])
            else:
                words.append(fillers[rng.integers(len(fillers))])
        lines.append(" ".join(words))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")

    with open(questions_path, "w") as f:
        f.write(": grid-semantic\n")
        seen = set()
        tries = 0
        while len(seen) < n_questions and tries < n_questions * 20:
            tries += 1
            a1, a2 = rng.choice(na, 2, replace=False)
            b1, b2 = rng.choice(nb, 2, replace=False)
            q = (composite[a1][b1], composite[a1][b2],
                 composite[a2][b1], composite[a2][b2])
            if q in seen:
                continue
            seen.add(q)
            f.write(" ".join(q) + "\n")
