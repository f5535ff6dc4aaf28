"""The fused CBOW step replayed from a CUDA graph.

A fused step (models/cbow_fused.fused_slab_step) issues about a hundred
kernels from Python: kernels 1, 2 and 7, the banded u-sum and the torch ops
around them.  On the card the host then sets the pace, not the device
(PERF.md section 5).  So a chunk of a replayable route captures its step
once into a CUDA graph and replays that graph for every later step: the
host issues a few copies and one replay a step.

What the graph reads sits at fixed addresses, owned by `_Graph`: the
step's inputs (slab tokens and sentence ids, shrinks, negatives), its
learning rate and its scatter plan, each copied in whole before each
replay, and the table, which is part of the key.  The loss of each step
adds, inside the graph, into the graph's float32 scalar, zeroed at chunk
entry, in the order of the eager chunk's sum, and the chunk returns a
copy of it.

A chunk whose key (the table's address, shape and dtype; the shapes and
dtypes of the step's inputs and plan) has no graph runs its first step
eagerly on the capture's stream, which settles cuBLAS's handle and
workspace and the lazy loading of the kernels, then captures the step (a
capture executes nothing, so the table is not stepped twice), and replays
every later step.  A graph is dropped when the tiled scatters' shared
workspace (kernels/span_scatter.workspace) has been regrown since its
capture: its pointers would be stale.  The graphs live in the chunk
closure, so each `train()` call captures its own.

The kernels' `.launches` counters stay true: a capture takes back what it
counted, and each replay adds the launches captured.  `StepCounts` counts
the steps replayed and those run eagerly, and the host seconds of the
captures; the spans `capture`, `step.inputs` and `step.replay`
(utils/trace.py) mark them.

Routes that replay: the `span` and `grmw` scatters, banded or
shifted-sum, with or without the context kernel.  Their steps were run on
the card under `torch.cuda.set_sync_debug_mode("error")` and replayed bit
for bit against the eager chunk (tests/test_torch_step_graph_card.py).
The others stay eager (`eager_reason` says why), as do the split-table
slab engine, skip-gram, the mesh and every CPU table.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from word2bits_tpu_torch.kernels import span_scatter
from word2bits_tpu_torch.kernels.band_usum import band_usum
from word2bits_tpu_torch.kernels.context_pallas import fused_context_pallas
from word2bits_tpu_torch.kernels.group_rmw import scatter_add_grmw_planned
from word2bits_tpu_torch.utils.trace import phase, span

# route option -> why a step with it stays eager
EAGER_ROUTES = (
    ("add", "the `add` scatter sorts its ids inside the step; not yet "
            "established as capturable on the card"),
    ("sweep", "kernel 9 builds its plan inside the step; not yet "
              "established as capturable on the card"),
    ("use_pallas", "runs only with the `add` scatter"),
    ("rmw_scatter", "runs only with the `add` scatter"),
    ("dedup_block", "runs only with the `add` scatter"),
    ("hot_rows", "runs only with the `add` scatter (the hot/cold split, "
                 "the stratified and dense-hot negatives)"),
)


def eager_reason(scatter_impl: str, **options) -> Optional[str]:
    """None if a fused step of this route replays from a CUDA graph, else
    why it stays eager (EAGER_ROUTES); `options` are the chunk's
    use_pallas, rmw_scatter, dedup_block and hot_rows."""
    why = dict(EAGER_ROUTES)
    if scatter_impl in why:
        return why[scatter_impl]
    for name, value in options.items():
        if value:
            return why[name]
    return None


def _counted() -> Tuple[Callable, ...]:
    """The launch-counting wrappers (`.launches`) of the kernels that a
    replayed route's step launches: kernel 1, kernel 2, kernel 7 (and
    `span_scatter.launch_parts`, which counts kernels 2 and 7 reading the
    step's rows from their parts) and the banded u-sum."""
    return (fused_context_pallas, span_scatter.scatter_add_span_planned,
            scatter_add_grmw_planned, span_scatter.launch_parts, band_usum)


@dataclass
class StepCounts:
    """Steps of an engine's chunks replayed from a graph and run eagerly
    (captures' warm-up steps among them), and the host seconds of its
    captures (`seconds["capture"]`, a phase: excluded from the enclosing
    chunk's `issue`)."""

    replayed: int = 0
    eager: int = 0
    seconds: Dict[str, float] = field(
        default_factory=lambda: {"capture": 0.0})


class _Graph:
    """One captured step and the buffers it reads."""

    def __init__(self, inputs, alpha, plan):
        self.inputs = type(inputs)(*(t.clone() for t in inputs))
        self.alpha = alpha.clone()
        self.plan = type(plan)(*(t.clone() for t in plan))
        # the chunk's loss: the steps' losses add into it, in the graph
        self.loss = torch.zeros((), dtype=torch.float32, device=alpha.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: List[Tuple[Callable, int]] = []
        self.workspace = None     # the scatter workspace it captured

    def load(self, inputs, alpha, plan) -> None:
        for dst, src in zip((*self.inputs, self.alpha, *self.plan),
                            (*inputs, alpha, *plan)):
            dst.copy_(src)

    def replay(self) -> None:
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n


def _key(table: torch.Tensor, inputs, alpha, plan) -> tuple:
    return (table.data_ptr(), tuple(table.shape), table.dtype,
            tuple((t.dtype, tuple(t.shape)) for t in (*inputs, alpha, *plan)))


class StepReplay:
    """The CUDA graphs of one chunk closure's fused step."""

    def __init__(self, counts: StepCounts):
        self.counts = counts
        self.graphs: Dict[tuple, _Graph] = {}

    def run(self, table: torch.Tensor, S: int,
            step_inputs: Callable[[int], tuple],
            step: Callable[..., torch.Tensor]) -> torch.Tensor:
        """S steps on the CUDA `table`: step_inputs(s) -> (SlabInputs,
        alpha, plan) of step s; step(inputs, alpha, plan) runs one step IN
        PLACE and returns its loss.  Returns the chunk's loss sum."""
        dev = table.device
        first = step_inputs(0)
        key = _key(table, *first)
        g = self.graphs.get(key)
        if g is not None and not _same(g.workspace,
                                       span_scatter.current_workspace(dev)):
            g = None      # its pointers into the old workspace are stale
        s0 = 0
        if g is None:
            g = self._capture(dev, first, step)
            # a new table leaves the graphs of the old one unreachable
            self.graphs = {k: v for k, v in self.graphs.items()
                           if k[0] == key[0]}
            self.graphs[key] = g
            s0 = 1
        else:
            g.loss.zero_()
        for s in range(s0, S):
            with span("step"):
                with span("step.inputs"):
                    g.load(*step_inputs(s))
                with span("step.replay"):
                    g.replay()
        self.counts.replayed += S - s0
        self.counts.eager += s0
        return g.loss.clone()

    def _capture(self, dev, first, step) -> _Graph:
        """Step `first` eagerly on the capture's stream, then the step
        captured from the same buffers."""
        main = torch.cuda.current_stream(dev)
        side = _capture_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            g = _Graph(*first)
            with span("step"):
                g.loss.add_(step(g.inputs, g.alpha, g.plan))
            g.workspace = span_scatter.current_workspace(dev)
            with phase("capture", self.counts.seconds):
                counters = _counted()
                before = [fn.launches for fn in counters]
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    g.loss.add_(step(g.inputs, g.alpha, g.plan))
                finally:
                    graph.capture_end()
                    # the capture ran nothing: its launches count at replay
                    g.launches = [(fn, fn.launches - n)
                                  for fn, n in zip(counters, before)
                                  if fn.launches != n]
                    for fn, n in zip(counters, before):
                        fn.launches = n
            if not _same(g.workspace, span_scatter.current_workspace(dev)):
                raise RuntimeError("the scatter workspace grew during a "
                                   "CUDA graph capture")
            g.graph = graph
        main.wait_stream(side)
        return g


# one capture stream per device for the process: cuBLAS keeps a workspace
# (32 MiB on the H100) for every stream it has run on until the process
# ends, so a stream of its own for each capture, or each train() call,
# would add one to the device's allocated memory every time
_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


def _same(a, b) -> bool:
    """Whether two workspaces (current_workspace) are the same tensors."""
    if a is None or b is None:
        return a is b
    return all(x is y for x, y in zip(a, b))
