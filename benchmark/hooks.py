"""The optional pieces of a model module's contract (benchmark/README.md,
"A configuration of another model") and their defaults.  A module that
gives none of them (CBOW's reference.py, skipgram.py) is checked and
counted as before they existed: each default is what the harness did
then.

- `vocab_words(spec, n_types) -> list[str]`: the vocabulary's words from
  the configuration's `corpus` entry alone (index 0 `</s>`); run.py and
  calibrate.py build the program's vocabulary from them.  Default
  `corpus.word_names`: `</s>`, w1, w2, ...;
- `bind(cfg, words, device)`: what the module derives once a run from the
  program's configuration and those words; the check hands it to
  `touched` and, as `hp`, to `step`, and work.StepShape carries it as
  `state`.  Default `hyper(cfg)`;
- `leaves(tables, cfg) -> list[Tensor]`: the trained tables as the leaves
  the check compares, any number, each [rows, width] with its own row
  count.  Default: a fused [V, 2D] table split into u and v, two tables
  as they are;
- `touched(state, slab_tokens, negs) -> list[LongTensor]`: per leaf, the
  sorted unique ids one step reads or writes.  Default `unique(slab
  tokens U negatives)` for both leaves;
- `negative_probs(counts) -> np.ndarray`: a negative's draw distribution
  over the ids; the check's draws, `sampler_tv` and the work counts read
  it.  Default `plain.negative_probs` (count^0.75).
"""

from __future__ import annotations

from typing import List

import torch

from benchmark import corpus, plain

OPTIONAL = ("vocab_words", "bind", "leaves", "touched", "negative_probs")


def default_leaves(tables, cfg) -> List[torch.Tensor]:
    D = cfg.size
    if len(tables) == 1:
        return [tables[0][:, :D], tables[0][:, D:]]
    return [tables[0], tables[1]]


def default_touched(state, slab_tokens: torch.Tensor,
                    negs: torch.Tensor) -> List[torch.Tensor]:
    ids = torch.unique(torch.cat([slab_tokens.clamp_min(0),
                                  negs.reshape(-1)]))
    return [ids, ids]


DEFAULTS = {"vocab_words": lambda spec, n_types: corpus.word_names(n_types),
            "leaves": default_leaves, "touched": default_touched,
            "negative_probs": plain.negative_probs}


def of(model, name: str):
    """The module's own `name` (one of OPTIONAL), or its default."""
    own = getattr(model, name, None)
    if own is not None:
        return own
    if name == "bind":
        return lambda cfg, words, device: model.hyper(cfg)
    return DEFAULTS[name]


def bound(model, cfg, device, n_types: int):
    """`bind` on the default vocabulary of n_types words, for a caller
    that has not made the run's words; ValueError where the module gives
    its own `vocab_words`, whose words such a caller would not see."""
    if getattr(model, "vocab_words", None) is not None:
        name = getattr(model, "__name__", "the model module")
        raise ValueError(f"{name} gives its own vocab_words: "
                         "bind it on the run's words and pass the state")
    return of(model, "bind")(cfg, corpus.word_names(n_types), device)
