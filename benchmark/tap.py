"""A passive recorder on the window's `train.train` call.

`word2bits_tpu_torch.train._train` builds its engine through the module
name `build_engine`; while `Tap` is entered that name returns the same
Engine with its chunk callable wrapped.  The wrapper calls the program's
chunk with the same arguments and records, per call, what the benchmark
checks the loop against (`check.schedule_errors`): the steps, the chunk's
scalars, which epoch arrays and which table it was handed and which table
it returned.  It keeps the engine (chunk callable, alias table) and the
newest epoch arrays for the check after the window: references only, no
copies, no device work and no synchronisation.

`fault` (tests and `calibrate.py` only) wraps the program's chunk in a
planted fault: "frozen" returns the tables as they came in, "half" hands
the chunk half of each batch (the second half's sentence ids set to -1)
at twice the rate, "plan0" gives every step of a chunk the first step's
share of the hoisted scatter plan, "nodecay" keeps the learning rate at
its start.  "frozen", "half" and "nodecay" act on the chunk's arguments
and results, and every engine can have them.  "plan0" replaces
models.cbow_fused.scatter_plan, which only the fused engine's `span` and
`grmw` scatters call: a chunk call that never calls it raises NotPlanted
(calibrate.py reads that mode as "n/a").
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


@dataclass
class Call:
    n_steps: int
    scalars: tuple            # ChunkScalars as a plain tuple
    tokens_id: int            # id() of the epoch arrays handed in
    table_in: int             # data_ptr of the first table handed in
    table_out: int            # data_ptr of the first table returned
    injected: bool            # shrinks/negatives given by the caller
    t: float                  # host clock at the call


@dataclass
class Tap:
    fault: Optional[str] = None
    batch: int = 0            # B, for the "half" fault
    calls: List[Call] = field(default_factory=list)
    engine: object = None
    chunk_fn: object = None   # the program's chunk (faulted where asked)
    tokens: Optional[torch.Tensor] = None
    sents: Optional[torch.Tensor] = None

    def __enter__(self):
        from word2bits_tpu_torch import train as train_mod
        self._mod = train_mod
        self._orig = train_mod.build_engine
        tap = self

        def build_engine(*args, **kwargs):
            eng = tap._orig(*args, **kwargs)
            tap.engine = eng
            tap.chunk_fn = faulted(eng.chunk_fn, tap.fault, tap.batch)
            eng.chunk_fn = tap._wrap(tap.chunk_fn)
            return eng

        train_mod.build_engine = build_engine
        return self

    def __exit__(self, *exc):
        self._mod.build_engine = self._orig
        return False

    def chunk_times(self):
        """Quartiles of the host time between the window's chunk calls."""
        t = [c.t for c in self.calls if not c.injected]
        d = sorted(b - a for a, b in zip(t, t[1:]))
        if len(d) < 4:
            return d
        return [d[len(d) // 4], d[len(d) // 2], d[3 * len(d) // 4]]

    def _wrap(self, fn):
        tap = self

        def chunk(*args, **kwargs):
            # (*tables, tokens, sents, atab, scalars, gen)
            i = len(args) - 5
            t = time.perf_counter()
            tokens, sents, scalars = args[i], args[i + 1], args[i + 3]
            if tap.tokens is not tokens:
                tap.tokens, tap.sents = tokens, sents
            out = fn(*args, **kwargs)
            tap.calls.append(Call(
                n_steps=int(kwargs.get("n_steps") or 0),
                scalars=tuple(scalars), tokens_id=id(tokens),
                table_in=args[0].data_ptr(), table_out=out[0].data_ptr(),
                injected=kwargs.get("negs") is not None, t=t))
            return out

        return chunk


class NotPlanted(Exception):
    """The cell's engine cannot have the planted fault: its chunk never
    reaches what the fault breaks."""


def faulted(fn, fault: Optional[str], B: int = 0):
    """The program's chunk `fn`, or `fn` broken by a planted fault."""
    if fault is None:
        return fn
    if fault == "frozen":
        def chunk(*args, **kwargs):
            n = len(args) - 5
            keep = [t.clone() for t in args[:n]]
            out = fn(*args, **kwargs)
            for t, k in zip(out[:n], keep):
                t.copy_(k)
            return out
        return chunk
    if fault == "half":
        def chunk(*args, **kwargs):
            from word2bits_tpu_torch.models.cbow import ChunkScalars
            n = len(args) - 5
            tables = args[:n]
            tokens, sents, atab, sc, gen = args[n:]
            S = int(kwargs.get("n_steps") or 1)
            sents = sents.clone()
            for s in range(S):
                b0 = sc.base0 + s * B
                sents[b0 + B // 2:b0 + B] = -1
            sc = ChunkScalars(sc.base0, 2.0 * sc.alpha0, *tuple(sc)[2:])
            return fn(*tables, tokens, sents, atab, sc, gen, **kwargs)
        return chunk
    if fault == "plan0":
        def chunk(*args, **kwargs):
            from word2bits_tpu_torch.models import cbow_fused
            orig = cbow_fused.scatter_plan
            planted = []

            def first_step(*a, **k):
                planted.append(True)
                return _FirstStep(orig(*a, **k))

            cbow_fused.scatter_plan = first_step
            try:
                out = fn(*args, **kwargs)
            finally:
                cbow_fused.scatter_plan = orig
            if not planted:
                raise NotPlanted("plan0: the chunk never calls "
                                 "models.cbow_fused.scatter_plan")
            return out
        return chunk
    if fault == "nodecay":
        def chunk(*args, **kwargs):
            from word2bits_tpu_torch.models.cbow import ChunkScalars
            n = len(args) - 5
            sc = args[n + 3]
            sc = ChunkScalars(sc.base0, sc.alpha0, 0.0, 0.0, sc.denom)
            return fn(*args[:n + 3], sc, args[n + 4], **kwargs)
        return chunk
    raise ValueError(f"unknown fault {fault!r}")


class _FirstStep:
    """A chunk's scatter plan whose every step is the first step's."""

    def __init__(self, plan):
        self._plan = plan

    def step(self, s):
        return self._plan.step(0)

