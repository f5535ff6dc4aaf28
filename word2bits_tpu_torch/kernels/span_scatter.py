"""Sorted in-place scatter-add: `table[ids] += rows`.

Kernel: csrc/span_scatter.cu, a CUDA C++ kernel for sm_90a that replaces
the JAX package's TPU span-sweep kernel (kernels/span_scatter.py,
`_span_kernel` via `_span_call`).  It keeps the contract, not the TPU
mechanism: rows are taken in the table dtype, duplicates are summed in
float32, each touched row gets ONE add in the table dtype with no atomics
on the table or on a sum (deterministic), ids outside [0, V) — the
0x7FFFFFF0 drop sentinel — are dropped, and the table is updated in place
with no table-sized temporary.

The plan is plain PyTorch: one stable sort of the ids plus the start of
every run of equal in-range ids.  It depends only on the ids, so the
training chunk builds it once for all S steps (batched over a leading
dimension) and each step launches only the kernel.  The kernel cuts the
sorted stream into tiles of 64 slots (and the columns into groups of at
most 128), one CTA each: a run inside a tile is summed there in chunks of
at most 4 rows, one thread each, and the chunks added in order; a run cut
by tile edges (the Zipf head) is summed piece by piece, in parallel, into
float32 partials, and the CTA of its last-arriving piece adds them in
tile order to the row.  So no thread sums more than 4 of a run's rows in
series, and the order is fixed by the plan.

Bound on the H100 (3.35 TB/s): bytes — the rows read once, each touched
table row read and written once (~10 us at the main path); the kernel's
time is in PERF.md.

`scatter_add_span_rank1` is the same scatter whose trailing rows are
rank-1, g[j] * cavg[j // per_src] (the per-center step's negative update at
reg == 0), formed inside the kernel (replacing the JAX package's
`scatter_add_span_rank1`, kernels/span_scatter.py:268): the [B*K, D] row
block is never materialized.  The JAX package measured it slower than the
materialized rows on the TPU, where XLA fused the broadcast multiply into
its gather; PyTorch fuses nothing, so here it saves a write and a read of
that block (PERF.md has both times).  The two entry points sum in one
order, so they are bit-equal on the same rows.

`scatter_add_span_sorted` launches the kernel from the two arrays it reads
of a plan, the stable sort's sorted ids and order: ops/scatter.scatter_add
sorts once per call and takes it for every plain scatter-add of the
training path on the card (the `add` routes, the cold rows of the hot/cold
split, the block dedup, the hot head's float32 sum, the mesh's deltas), so
the same seed gives the same tables.

`scatter_add_span_planned` / `scatter_add_span` / `scatter_add_span_sorted`
/ `scatter_add_span_rank1` run the plain version for CPU tensors (an f32 `index_add_` into a temporary
holding the touched rows, then one cast-add) and launch the kernel for
CUDA tensors, raising on what it does not take; there is no fallback.
Every launch on a device uses the same workspace (`workspace`, shared
with kernels 6, 7 and 8), so two calls must not run at once on different
streams; no path of the port does that.
`scatter_add_span_planned.launches` (kernel 2, through either of its entry
points) and `scatter_add_span_rank1.launches` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library

SENTINEL = 0x7FFFFFF0   # drop id, as in the JAX package
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class SpanPlan(NamedTuple):
    """Pure function of (ids, V); leading dimensions batch S steps."""

    order: torch.Tensor      # [..., N] int32 source row of each sorted slot
    sids: torch.Tensor       # [..., N] int32 sorted ids
    run_start: torch.Tensor  # [..., N+1] int32 start of each run of equal
    #                          in-range ids; run_start[n_runs] = end of the
    #                          in-range ids, N after that
    n_runs: torch.Tensor     # [...] int32 number of runs

    def step(self, s: int) -> "SpanPlan":
        """The plan of step s of a batched plan."""
        return SpanPlan(*(a[s] for a in self))


def span_plan(ids: torch.Tensor, V: int) -> SpanPlan:
    """Sort/run plan of `ids` ([..., N]) against a table of V rows."""
    N = ids.shape[-1]
    sids, order = torch.sort(ids, dim=-1, stable=True)
    in_range = (sids >= 0) & (sids < V)
    new = torch.ones_like(in_range)
    new[..., 1:] = sids[..., 1:] != sids[..., :-1]
    start = new & in_range
    n_runs = start.sum(dim=-1)
    pos = torch.arange(N, device=ids.device).expand(sids.shape)
    # starts go to their run's slot, everything else to a spare slot N+1
    dest = torch.where(start, torch.cumsum(start, dim=-1) - 1, N + 1)
    run_start = torch.full(ids.shape[:-1] + (N + 2,), N, dtype=torch.int64,
                           device=ids.device)
    run_start.scatter_(-1, dest, pos)
    # ids < 0 sort first, so the in-range ids end at (#ids < V)
    run_start.scatter_(-1, n_runs[..., None],
                       (sids < V).sum(dim=-1, keepdim=True))
    i32 = torch.int32
    return SpanPlan(order=order.to(i32), sids=sids.to(i32),
                    run_start=run_start[..., :N + 1].to(i32),
                    n_runs=n_runs.to(i32))


def scatter_add_span_plain(table: torch.Tensor, ids: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: an f32 index_add_ into a temporary that
    holds only the touched rows, then one cast-add into the table."""
    V, C = table.shape
    keep = (ids >= 0) & (ids < V)
    touched, slot = torch.unique(ids[keep].long(), return_inverse=True)
    acc = torch.zeros((touched.numel(), C), dtype=torch.float32,
                      device=table.device)
    acc.index_add_(0, slot, rows[keep].to(table.dtype).to(torch.float32))
    table[touched] = (table[touched].to(torch.float32) + acc).to(table.dtype)
    return table


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/span_scatter.cu, built on first use, with its C signatures."""
    lib = load_library("span_scatter")
    lib.w2b_span_scatter.argtypes = ([ctypes.c_void_p] * 6
                                     + [ctypes.c_int] * 5
                                     + [ctypes.c_void_p])
    lib.w2b_span_scatter.restype = ctypes.c_int
    lib.w2b_span_scatter_rank1.argtypes = ([ctypes.c_void_p] * 8
                                           + [ctypes.c_int] * 7
                                           + [ctypes.c_void_p])
    lib.w2b_span_scatter_rank1.restype = ctypes.c_int
    lib.w2b_span_tile.restype = ctypes.c_int
    for fn in (lib.w2b_span_partials, lib.w2b_span_counters):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_longlong
    return lib


_WORKSPACE: dict = {}


def workspace(device: torch.device, n_part: int, n_count: int):
    """The tiled scatter kernels' workspace on `device` (csrc/w2b_tiles.cuh:
    kernels 2, 3, 6, 7 and 8): n_part float32 partials (2 per tile of the
    sorted stream, C wide) and n_count int32 arrival counters (1 per tile
    and column group), allocated zero once and grown when a call needs more;
    each call leaves the counters zero.  Every call on the device shares
    it, so two calls must not run at once on different streams (no path of
    the port does that)."""
    part, count = _WORKSPACE.get(device, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if count is None or count.numel() < n_count:
        count = torch.zeros(n_count, dtype=torch.int32, device=device)
    _WORKSPACE[device] = (part, count)
    return part, count


def tile_constants(config_fn) -> dict:
    """The tile constants a tiled scatter kernel was built with, read
    through its C `..._config` entry point."""
    out = (ctypes.c_int * 5)()
    config_fn(out)
    return dict(zip(("L", "THREADS", "SUB", "IB", "GROUP"), out))


def _check_sorted(fn: str, table, sids, order, rows, C: int,
                  *others) -> None:
    """Raise on anything the kernel does not take; `sids` and `order` are
    one step's sorted ids and their source rows (what the kernel reads of
    a plan), `rows` the materialized (or dense) row block, `others`
    (name, tensor) pairs of further float32 inputs."""
    dev = table.device
    if table.dtype not in _DTYPES:
        raise ValueError(f"{fn}: table dtype {table.dtype} is not float32 "
                         "or bfloat16")
    if rows.dtype not in (torch.float32, table.dtype):
        raise ValueError(f"{fn}: rows must be float32 or {table.dtype}, got "
                         f"{rows.dtype}")
    if rows.dim() != 2 or rows.shape[1] != C:
        raise ValueError(f"{fn}: rows {tuple(rows.shape)} do not have the "
                         f"table's width {C}")
    if sids.dim() != 1 or order.shape != sids.shape:
        raise ValueError(f"{fn}: pass one step's plan (SpanPlan.step)")
    for name, t in (("table", table), ("rows", rows), ("order", order),
                    ("sids", sids), *others):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, table on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    for name, t in others:
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
    for name, t in (("order", order), ("sids", sids)):
        if t.dtype != torch.int32:
            raise ValueError(f"{fn}: {name} must be int32")


def _check(fn: str, table, plan: SpanPlan, rows, C: int, *others) -> None:
    """_check_sorted on a plan, whose other fields must be well formed
    too."""
    _check_sorted(fn, table, plan.sids, plan.order, rows, C, *others)
    for name, t in (("run_start", plan.run_start), ("n_runs", plan.n_runs)):
        if t.device != table.device or not t.is_contiguous():
            raise ValueError(f"{fn}: plan.{name} must be contiguous on "
                             f"{table.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{fn}: plan.{name} must be int32")
    if plan.run_start.shape[-1] != plan.sids.shape[-1] + 1:
        raise ValueError(f"{fn}: plan.run_start must have N+1 entries")


def _plan_ptrs(sids, order, C: int):
    """The kernel's sorted-id, order and workspace pointers."""
    lib, N = _library(), sids.shape[-1]
    part, count = workspace(sids.device, lib.w2b_span_partials(N, C),
                            lib.w2b_span_counters(N, C))
    return (sids.data_ptr(), order.data_ptr(), part.data_ptr(),
            count.data_ptr())


def _launch(table, sids, order, rows):
    """Kernel 2 on checked inputs (_check_sorted)."""
    V, C = table.shape
    N = sids.shape[-1]
    if rows.shape[0] != N:
        raise ValueError(f"scatter_add_span: {rows.shape[0]} rows vs "
                         f"{N} sorted ids")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _library().w2b_span_scatter(
        table.data_ptr(), rows.data_ptr(), *_plan_ptrs(sids, order, C), N,
        V, C, _DTYPES[table.dtype], _DTYPES[rows.dtype], stream)
    check_launch("w2b_span_scatter", err)
    scatter_add_span_planned.launches += 1
    return table


def scatter_add_span_planned(table: torch.Tensor, plan: SpanPlan,
                             rows: torch.Tensor) -> torch.Tensor:
    """Apply one step's span_plan: table[ids] += rows, in place.
    rows [N, C] in float32 or the table dtype, in the ids' original order."""
    if table.device.type == "cpu":
        return scatter_add_span_plain(table, plan.sids,
                                      rows[plan.order.long()])
    if table.device.type != "cuda":
        raise ValueError("scatter_add_span runs on cpu (plain version) or "
                         f"cuda (kernel), not {table.device}")
    _check("scatter_add_span", table, plan, rows, table.shape[1])
    return _launch(table, plan.sids, plan.order, rows)


scatter_add_span_planned.launches = 0


def scatter_add_span_sorted(table: torch.Tensor, sids: torch.Tensor,
                            order: torch.Tensor,
                            rows: torch.Tensor) -> torch.Tensor:
    """table[ids] += rows in place from the ids' stable sort alone: sids
    [N] int32 the sorted ids and order [N] int32 the source row of each
    sorted slot (torch.sort(ids, stable=True)), rows [N, C] in float32 or
    the table dtype, in the ids' original order.  What the kernel reads of
    a span_plan, for a caller that sorts once per call
    (ops/scatter.scatter_add); its launches count with
    scatter_add_span_planned's."""
    if table.device.type == "cpu":
        return scatter_add_span_plain(table, sids, rows[order.long()])
    if table.device.type != "cuda":
        raise ValueError("scatter_add_span runs on cpu (plain version) or "
                         f"cuda (kernel), not {table.device}")
    _check_sorted("scatter_add_span", table, sids, order, rows,
                  table.shape[1])
    return _launch(table, sids, order, rows)


def scatter_add_span(table: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """table[ids] += rows in place (ids [N], rows [N, C]); builds the plan
    and applies it."""
    return scatter_add_span_planned(table, span_plan(ids, table.shape[0]),
                                    rows)


def scatter_add_span_rank1_plain(table: torch.Tensor, plan: SpanPlan,
                                 dense_rows: torch.Tensor, g: torch.Tensor,
                                 cavg: torch.Tensor,
                                 per_src: int) -> torch.Tensor:
    """The plain version of scatter_add_span_rank1: materializes the rows
    (each rank-1 row formed in float32) and applies the plan."""
    nn = g.shape[0]
    src = torch.arange(nn, device=g.device) // per_src
    rows = torch.cat([dense_rows.to(torch.float32),
                      g.to(torch.float32)[:, None]
                      * cavg.to(torch.float32)[src]])
    return scatter_add_span_plain(table, plan.sids, rows[plan.order.long()])


def _launch_rank1(table, plan: SpanPlan, dense_rows, g, cavg, per_src: int):
    V, C = table.shape
    N = plan.sids.shape[-1]
    nd, nn = dense_rows.shape[0], g.shape[0]
    fn = "scatter_add_span_rank1"
    _check(fn, table, plan, dense_rows, C, ("g", g), ("cavg", cavg))
    if nd + nn != N or per_src < 1 or nn % per_src:
        raise ValueError(f"{fn}: {nd} dense + {nn} rank-1 rows vs a plan of "
                         f"{N} ids with {per_src} rows per source")
    if g.dim() != 1 or cavg.shape != (nn // per_src, C):
        raise ValueError(f"{fn}: g must be [{nn}] and cavg "
                         f"[{nn // per_src}, {C}], got {tuple(g.shape)} and "
                         f"{tuple(cavg.shape)}")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _library().w2b_span_scatter_rank1(
        table.data_ptr(), dense_rows.data_ptr(), g.data_ptr(),
        cavg.data_ptr(), *_plan_ptrs(plan.sids, plan.order, C), N, nd,
        per_src, V, C,
        _DTYPES[table.dtype], _DTYPES[dense_rows.dtype], stream)
    check_launch("w2b_span_scatter_rank1", err)
    scatter_add_span_rank1.launches += 1
    return table


def scatter_add_span_rank1(table: torch.Tensor, plan: SpanPlan,
                           dense_rows: torch.Tensor, g: torch.Tensor,
                           cavg: torch.Tensor,
                           per_src: int) -> torch.Tensor:
    """table[ids] += rows in place, where `plan` is the span_plan of the
    ids [dense_ids; rank1_ids] and the rows are dense_rows [nd, C] (float32
    or the table dtype) followed by nn rank-1 rows g[j] * cavg[j //
    per_src] (g [nn] and cavg [nn / per_src, C] float32)."""
    if table.device.type == "cpu":
        return scatter_add_span_rank1_plain(table, plan, dense_rows, g, cavg,
                                            per_src)
    if table.device.type != "cuda":
        raise ValueError("scatter_add_span_rank1 runs on cpu (plain version) "
                         f"or cuda (kernel), not {table.device}")
    return _launch_rank1(table, plan, dense_rows, g, cavg, per_src)


scatter_add_span_rank1.launches = 0
