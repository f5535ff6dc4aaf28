"""Sorted in-place scatter-add: `table[ids] += rows`.

Kernel: csrc/span_scatter.cu, a CUDA C++ kernel for sm_90a that replaces
the JAX package's TPU span-sweep kernel (kernels/span_scatter.py,
`_span_kernel` via `_span_call`).  It keeps the contract, not the TPU
mechanism: rows are taken in the table dtype, duplicates are summed in
float32, each touched row gets ONE add in the table dtype with no atomics
on the table or on a sum (deterministic), ids outside [0, V) — the
0x7FFFFFF0 drop sentinel — are dropped, and the table is updated in place
with no table-sized temporary.

The plan is plain PyTorch: the stable sort of the ids (`sort_plan`, a
`SortPlan` of the sorted ids and the source row of each), all that
kernels 2, 3, 7 and 8 read of the ids.  It depends only on the ids, so the
training chunk builds it once for all S steps (batched over a leading
dimension) and each step launches only the kernel.  The kernel cuts the
sorted stream into tiles of 64 slots (and the columns into groups of at
most 128), one CTA each: a run of equal ids inside a tile is summed there
in chunks of at most 4 rows, one thread each, and the chunks added in
order; a run cut by tile edges (the Zipf head) is summed piece by piece,
in parallel, into float32 partials, and the CTA of its last-arriving piece
adds them in tile order to the row.  So no thread sums more than 4 of a
run's rows in series, and the order is fixed by the sort.

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

ops/scatter.scatter_add sorts once per call and takes kernel 2 for every
plain scatter-add of the training path on the card (the `add` routes, the
cold rows of the hot/cold split, the block dedup, the hot head's float32
sum, the mesh's deltas), so the same seed gives the same tables.

The fused CBOW step hands kernel 2 (and kernel 7, kernels/group_rmw.py)
its update rows as `RowParts`, the three buffers its phases wrote, which
the kernel reads in place (`w2b_span_scatter_parts`): the [N, 2D] rows
are never assembled, and their zero halves are not read.  The CPU
materializes them (`RowParts.materialize`) for the plain version.

`scatter_add_span_planned` / `scatter_add_span` / `scatter_add_span_rank1`
run the plain version for CPU tensors (an f32 `index_add_` into a
temporary holding the touched rows, then one cast-add) and launch the
kernel for CUDA tensors, raising on what it does not take (`check_sorted`,
shared with kernels 7 and 8); there is no fallback.  Every launch on a
device uses the same workspace (`workspace`, shared with kernels 6, 7 and
8), so two calls must not run at once on different streams; no path of
the port does that.  `scatter_add_span_planned.launches` (kernel 2) and
`scatter_add_span_rank1.launches` count kernel launches;
`launch_parts.launches` counts those of kernels 2 and 7 that read
RowParts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library

SENTINEL = 0x7FFFFFF0   # drop id, as in the JAX package
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class SortPlan(NamedTuple):
    """The stable sort of a scatter's ids; leading dimensions batch S
    steps."""

    order: torch.Tensor      # [..., N] int32 source row of each sorted slot
    sids: torch.Tensor       # [..., N] int32 sorted ids

    def step(self, s: int) -> "SortPlan":
        """The plan of step s of a batched plan."""
        return SortPlan(*(a[s] for a in self))


class RowParts(NamedTuple):
    """The fused CBOW step's update rows [n_slab + n_neg, 2D]
    (models/cbow_fused.py) as the three buffers its phases wrote: slab row
    o is [du_slab[o], dv_center[o - window]], its v half zero outside the
    centers window .. n_slab - window - 1, and negative row j is [0,
    dv_neg[j]].  Kernels 2 and 7 read them so (csrc/w2b_rows.cuh
    SlabParts); `materialize` assembles them."""

    du_slab: torch.Tensor     # [n_slab, D] u rows of the slab positions
    dv_center: torch.Tensor   # [n_slab - 2 * window, D] v rows of the centers
    dv_neg: torch.Tensor      # [n_neg, D] v rows of the negatives
    window: int

    def materialize(self) -> torch.Tensor:
        """The rows [n_slab + n_neg, 2D], in du_slab's dtype."""
        W, n_slab = self.window, self.du_slab.shape[0]
        dv_slab = torch.zeros_like(self.du_slab)
        dv_slab[W:n_slab - W] = self.dv_center
        fused_rows = torch.cat([self.du_slab, dv_slab], dim=1)
        return torch.cat([fused_rows, torch.cat(
            [torch.zeros_like(self.dv_neg), self.dv_neg], dim=1)])


def sort_plan(ids: torch.Tensor) -> SortPlan:
    """One stable sort of `ids` ([..., N]) along its last dimension.  Ids
    outside [0, V) stay in it: the kernels and their plain versions drop
    them."""
    sids, order = torch.sort(ids, dim=-1, stable=True)
    return SortPlan(order=order.to(torch.int32), sids=sids.to(torch.int32))


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


# the C signature of w2b_span_scatter_parts and w2b_group_rmw_parts
PARTS_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                  + [ctypes.c_void_p])


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
    lib.w2b_span_scatter_parts.argtypes = PARTS_ARGTYPES
    lib.w2b_span_scatter_parts.restype = ctypes.c_int
    lib.w2b_span_tile.restype = ctypes.c_int
    for fn in (lib.w2b_span_partials, lib.w2b_span_counters):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_longlong
    return lib


_WORKSPACE: dict = {}


def workspace(device: torch.device, n_part: int, n_count: int):
    """The tiled scatter kernels' workspace on `device` (csrc/w2b_tiles.cuh:
    kernels 2, 3, 6, 7 and 8; kernel 12's backward, kernels/pos_context.py,
    takes it too): n_part float32 partials (2 per tile of the sorted
    stream, C wide) and n_count int32 arrival counters (1 per tile and
    column group), allocated zero once and grown when a call needs more;
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


def current_workspace(device: torch.device):
    """The (partials, counters) workspace on `device` as it stands, or
    None before any call there."""
    return _WORKSPACE.get(device)


def tile_constants(config_fn) -> dict:
    """The tile constants a tiled scatter kernel was built with, read
    through its C `..._config` entry point."""
    out = (ctypes.c_int * 5)()
    config_fn(out)
    return dict(zip(("L", "THREADS", "SUB", "IB", "GROUP"), out))


def _check_table_plan(fn: str, table, plan: SortPlan, named) -> None:
    """The table's dtype, one step's int32 plan, and every tensor of
    `named` ((name, tensor) pairs) contiguous on the table's device."""
    dev = table.device
    if table.dtype not in _DTYPES:
        raise ValueError(f"{fn}: table dtype {table.dtype} is not float32 "
                         "or bfloat16")
    if plan.sids.dim() != 1:
        raise ValueError(f"{fn}: pass one step's plan (SortPlan.step)")
    if plan.order.shape != plan.sids.shape:
        raise ValueError(f"{fn}: plan.order {tuple(plan.order.shape)} vs "
                         f"plan.sids {tuple(plan.sids.shape)}")
    named = (("table", table), ("plan.order", plan.order),
             ("plan.sids", plan.sids), *named)
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, table on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    for name, t in zip(SortPlan._fields, plan):
        if t.dtype != torch.int32:
            raise ValueError(f"{fn}: plan.{name} must be int32")


def check_sorted(fn: str, table, plan: SortPlan, rows, *others) -> None:
    """Raise on anything a tiled scatter kernel (2, 3, 7 or 8) does not
    take: `plan` one step's SortPlan, `rows` the materialized (or dense)
    row block, `others` (name, tensor) pairs of further float32 inputs;
    `fn` names the caller in errors.  The caller checks the row count."""
    C = table.shape[1]
    if rows.dtype not in (torch.float32, table.dtype):
        raise ValueError(f"{fn}: rows must be float32 or {table.dtype}, got "
                         f"{rows.dtype}")
    if rows.dim() != 2 or rows.shape[1] != C:
        raise ValueError(f"{fn}: rows {tuple(rows.shape)} do not have the "
                         f"table's width {C}")
    _check_table_plan(fn, table, plan, (("rows", rows), *others))
    for name, t in others:
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")


def check_parts(fn: str, table, plan: SortPlan, parts: RowParts) -> None:
    """Raise on anything kernels 2 and 7 do not take from the fused step's
    RowParts: its three parts D = C / 2 wide, in one dtype (float32 or the
    table's), du_slab [n_slab, D], dv_center [n_slab - 2W, D] and dv_neg
    [N - n_slab, D] for a plan of N ids; `fn` names the caller in errors."""
    C, N = table.shape[1], plan.sids.shape[-1]
    named = tuple(zip(RowParts._fields, parts[:3]))
    du, dvc, dvn = parts[:3]
    if du.dtype not in (torch.float32, table.dtype):
        raise ValueError(f"{fn}: rows must be float32 or {table.dtype}, got "
                         f"{du.dtype}")
    for name, t in named:
        if t.dtype != du.dtype:
            raise ValueError(f"{fn}: {name} is {t.dtype}, du_slab "
                             f"{du.dtype}")
        if C % 2 or t.dim() != 2 or 2 * t.shape[1] != C:
            raise ValueError(f"{fn}: {name} {tuple(t.shape)} is not half "
                             f"the table's width {C}")
    n_slab, W = du.shape[0], parts.window
    if W < 0 or dvc.shape[0] != n_slab - 2 * W or n_slab + dvn.shape[0] != N:
        raise ValueError(f"{fn}: {n_slab} slab rows (window {W}), "
                         f"{dvc.shape[0]} center rows and {dvn.shape[0]} "
                         f"negative rows vs a plan of {N} ids")
    _check_table_plan(fn, table, plan, named)


def launch_parts(fn: str, kernel, partials, counters, table,
                 plan: SortPlan, parts: RowParts) -> None:
    """Launch `kernel` (w2b_span_scatter_parts, kernel 2, or
    w2b_group_rmw_parts, kernel 7; `partials` and `counters` size its
    workspace) on one step's plan and the fused step's RowParts, checked
    (check_parts) in `fn`'s name.  `launch_parts.launches` counts the
    launches of either kernel that read the three parts."""
    check_parts(fn, table, plan, parts)
    V, C = table.shape
    N = plan.sids.shape[-1]
    part, count = workspace(table.device, partials(N, C), counters(N, C))
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = kernel(table.data_ptr(), *(t.data_ptr() for t in parts[:3]),
                 plan.sids.data_ptr(), plan.order.data_ptr(),
                 part.data_ptr(), count.data_ptr(), N,
                 parts.du_slab.shape[0], parts.window, V, C // 2,
                 _DTYPES[table.dtype], _DTYPES[parts.du_slab.dtype], stream)
    check_launch(kernel.__name__, err)
    launch_parts.launches += 1


launch_parts.launches = 0


def _plan_ptrs(plan: SortPlan, C: int):
    """The kernel's sorted-id, order and workspace pointers."""
    lib, N = _library(), plan.sids.shape[-1]
    part, count = workspace(plan.sids.device, lib.w2b_span_partials(N, C),
                            lib.w2b_span_counters(N, C))
    return (plan.sids.data_ptr(), plan.order.data_ptr(), part.data_ptr(),
            count.data_ptr())


def _launch(table, plan: SortPlan, rows):
    """Kernel 2 on one step's plan, its rows dense or RowParts."""
    lib = _library()
    if isinstance(rows, RowParts):
        launch_parts("scatter_add_span", lib.w2b_span_scatter_parts,
                     lib.w2b_span_partials, lib.w2b_span_counters, table,
                     plan, rows)
        scatter_add_span_planned.launches += 1
        return table
    V, C = table.shape
    N = plan.sids.shape[-1]
    check_sorted("scatter_add_span", table, plan, rows)
    if rows.shape[0] != N:
        raise ValueError(f"scatter_add_span: {rows.shape[0]} rows vs "
                         f"{N} sorted ids")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.w2b_span_scatter(
        table.data_ptr(), rows.data_ptr(), *_plan_ptrs(plan, C), N, V, C,
        _DTYPES[table.dtype], _DTYPES[rows.dtype], stream)
    check_launch("w2b_span_scatter", err)
    scatter_add_span_planned.launches += 1
    return table


def scatter_add_span_planned(table: torch.Tensor, plan: SortPlan,
                             rows: torch.Tensor | RowParts) -> torch.Tensor:
    """Apply one step's sort_plan: table[ids] += rows, in place.
    rows [N, C] in float32 or the table dtype, in the ids' original order,
    or the fused step's RowParts (materialized on the CPU)."""
    if table.device.type == "cpu":
        if isinstance(rows, RowParts):
            rows = rows.materialize()
        return scatter_add_span_plain(table, plan.sids,
                                      rows[plan.order.long()])
    if table.device.type != "cuda":
        raise ValueError("scatter_add_span runs on cpu (plain version) or "
                         f"cuda (kernel), not {table.device}")
    return _launch(table, plan, rows)


scatter_add_span_planned.launches = 0


def scatter_add_span(table: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """table[ids] += rows in place (ids [N], rows [N, C]); builds the plan
    and applies it."""
    return scatter_add_span_planned(table, sort_plan(ids), rows)


def scatter_add_span_rank1_plain(table: torch.Tensor, plan: SortPlan,
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


def _launch_rank1(table, plan: SortPlan, dense_rows, g, cavg, per_src: int):
    V, C = table.shape
    N = plan.sids.shape[-1]
    nd, nn = dense_rows.shape[0], g.shape[0]
    fn = "scatter_add_span_rank1"
    check_sorted(fn, table, plan, dense_rows, ("g", g), ("cavg", cavg))
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
        cavg.data_ptr(), *_plan_ptrs(plan, C), N, nd, per_src, V, C,
        _DTYPES[table.dtype], _DTYPES[dense_rows.dtype], stream)
    check_launch("w2b_span_scatter_rank1", err)
    scatter_add_span_rank1.launches += 1
    return table


def scatter_add_span_rank1(table: torch.Tensor, plan: SortPlan,
                           dense_rows: torch.Tensor, g: torch.Tensor,
                           cavg: torch.Tensor,
                           per_src: int) -> torch.Tensor:
    """table[ids] += rows in place, where `plan` is the sort_plan of the
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
