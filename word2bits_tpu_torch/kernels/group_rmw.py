"""Sorted scatter-add: `table[ids] += rows`, the capacity path's
parameter update (`-scatter-impl grmw`).

Kernel: `w2b_group_rmw` in csrc/group_rmw.cu, a CUDA C++ kernel for sm_90a
that replaces the JAX package's TPU kernel (kernels/group_rmw.py,
`_group_kernel` via `_group_call`).  The public functions keep the JAX
names and contracts: each row is first rounded to the table dtype,
duplicates are summed in float32, each touched row gets ONE add in the
table dtype with no atomics on the table or on a sum, ids outside [0, V) —
negative ids, the 0x7FFFFFF0 drop sentinel — are dropped, and the table is
updated in place with no table-sized temporary.

The plan is plain PyTorch, a pure function of the ids (batched over leading
dimensions, so the training chunk builds it once for all S steps): one
stable sort, the runs of equal ids, and the VISITS — the runs grouped by
their `grp`-row table group (16 rows bf16, 8 float32, the JAX kernel's DMA
granule), one visit per touched group over the whole sorted stream, or one
per run for a group holding more than SPLIT_ROWS rows.  Kernel 7 reads only
the sorted ids and their source rows: it is the tiled template of
csrc/w2b_tiles.cuh (kernels 2, 3, 6 and 8 run it too, with their own
constants), which cuts the sorted stream into tiles and the columns into
groups, one CTA each, and sums a run cut by tile edges piece by piece
into float32 partials of the per-device workspace
(`span_scatter.workspace`), the CTA whose piece arrives last adding them
in tile order.  Kernel 8
(kernels/scatter_pallas.py) runs the same template on the same sorted
stream with a rounding epilogue.  No kernel reads the run and visit tables
(`run_start`, `vis_run`, `n_vis`): they stay in the plan for its JAX
counterpart's contract and its tests.  The earlier design gave one CTA to
each visit, a chain of dependent loads per run (PERF.md section 6 has its
times).

`chunk` and `slots` size the TPU kernel's blocks and DMA slots; they have no
role on the card and are kept for the signature, with the JAX kernel's one
hazard turned into an error: `chunk < slots` (its preamble reads past the
block there) raises.

Unlike the JAX kernel, the table needs no padding: any V and any row width.

Bound on the H100 (3.35 TB/s): bytes — the rows read once, each touched
table row read and written once, and the plan (~70 us at the flagship's
22,544 f32 rows x 1,600 columns); the kernel's time is in PERF.md.

`scatter_add_grmw_planned` / `scatter_add_grmw` run the plain version for
CPU tensors (an f32 `index_add_` into a temporary holding the touched rows,
then one cast-add) and launch the kernel for CUDA tensors, raising on what
it does not take; there is no fallback.  Every launch on a device uses the
workspace shared with kernels 2, 3, 6 and 8, so two calls must not run at
once on different streams; no path of the port does that.
`scatter_add_grmw_planned.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library
from word2bits_tpu_torch.kernels.span_scatter import (SENTINEL,
                                                      scatter_add_span_plain,
                                                      tile_constants,
                                                      workspace)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# a group with more rows than this gets one visit per run (per id)
SPLIT_ROWS = 64


def group_rows(dtype: torch.dtype) -> int:
    """Rows per group: the JAX kernel's sublane tile, 32 bytes of rows
    (16 bf16 rows, 8 float32)."""
    return 32 // dtype.itemsize


class GroupPlan(NamedTuple):
    """Pure function of (ids, grp); leading dimensions batch S steps."""

    order: torch.Tensor      # [..., N] int32 source row of each sorted slot
    sids: torch.Tensor       # [..., N] int32 sorted ids
    run_start: torch.Tensor  # [..., N+1] int32 start of each run of equal
    #                          ids in [0, SENTINEL); run_start[n_runs] = end
    #                          of those ids, N after that
    vis_run: torch.Tensor    # [..., N+1] int32 first run of each visit (a
    #                          touched group, or one id of a group above
    #                          SPLIT_ROWS rows); vis_run[n_vis] = n_runs
    n_vis: torch.Tensor      # [...] int32 number of visits

    def step(self, s: int) -> "GroupPlan":
        """The plan of step s of a batched plan."""
        return GroupPlan(*(a[s] for a in self))


def group_plan(ids: torch.Tensor, grp: int, chunk: int = 128) -> GroupPlan:
    """Sorted-visit plan of `ids` ([..., N]) for groups of `grp` rows.
    `chunk` (the JAX plan's block size) does not shape this plan."""
    if grp <= 0 or grp & (grp - 1):
        raise ValueError(f"group_plan: grp must be a power of two, got {grp}")
    if chunk <= 0:
        raise ValueError(f"group_plan: chunk must be positive, got {chunk}")
    N = ids.shape[-1]
    sids, order = torch.sort(ids, dim=-1, stable=True)
    valid = (sids >= 0) & (sids < SENTINEL)
    wid = sids >> (grp.bit_length() - 1)
    new_run = torch.ones_like(valid)
    new_run[..., 1:] = sids[..., 1:] != sids[..., :-1]
    new_run &= valid
    new_grp = torch.ones_like(valid)
    new_grp[..., 1:] = wid[..., 1:] != wid[..., :-1]
    new_grp &= valid
    # rows per group, seen from each position (invalid ones count in slot N)
    gslot = torch.where(valid, torch.cumsum(new_grp, dim=-1) - 1, N)
    grp_rows = torch.zeros(ids.shape[:-1] + (N + 1,), dtype=torch.int64,
                           device=ids.device)
    grp_rows.scatter_add_(-1, gslot, torch.ones_like(gslot))
    heavy = grp_rows.gather(-1, gslot) > SPLIT_ROWS
    new_vis = new_grp | (new_run & heavy)
    run_idx = torch.cumsum(new_run, dim=-1) - 1
    n_runs = new_run.sum(dim=-1)
    pos = torch.arange(N, device=ids.device).expand(sids.shape)
    # starts go to their run's (visit's) slot, everything else to spare N+1
    run_start = torch.full(ids.shape[:-1] + (N + 2,), N, dtype=torch.int64,
                           device=ids.device)
    run_start.scatter_(-1, torch.where(new_run, run_idx, N + 1), pos)
    # negative ids sort first, so the valid ids end at (#ids < SENTINEL)
    run_start.scatter_(-1, n_runs[..., None],
                       (sids < SENTINEL).sum(dim=-1, keepdim=True))
    vis_run = n_runs[..., None].expand(ids.shape[:-1] + (N + 2,)).clone()
    vis_run.scatter_(-1, torch.where(new_vis,
                                     torch.cumsum(new_vis, dim=-1) - 1,
                                     N + 1), run_idx)
    i32 = torch.int32
    return GroupPlan(order=order.to(i32), sids=sids.to(i32),
                     run_start=run_start[..., :N + 1].to(i32),
                     vis_run=vis_run[..., :N + 1].to(i32),
                     n_vis=new_vis.sum(dim=-1).to(i32))


def scatter_add_grmw_plain(table: torch.Tensor, ids: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (the same function as the span scatter's):
    an f32 index_add_ into a temporary that holds only the touched rows,
    then one cast-add into the table."""
    return scatter_add_span_plain(table, ids, rows)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/group_rmw.cu (w2b_group_rmw, kernel 7, and w2b_scatter_rmw,
    kernel 8, both on the tile template), built on first use, with its C
    signatures."""
    lib = load_library("group_rmw")
    for k in ("group_rmw", "scatter_rmw"):
        fn = getattr(lib, f"w2b_{k}")
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for size in (getattr(lib, f"w2b_{k}_partials"),
                     getattr(lib, f"w2b_{k}_counters")):
            size.argtypes = [ctypes.c_int, ctypes.c_int]
            size.restype = ctypes.c_longlong
        getattr(lib, f"w2b_{k}_config").argtypes = [ctypes.c_void_p]
    return lib


def tile_config() -> dict:
    """Kernel 7's tile constants, as built."""
    return tile_constants(_library().w2b_group_rmw_config)


def _check_slots(chunk: int, slots: int) -> None:
    if chunk < slots:
        raise ValueError(
            f"scatter_add_grmw: chunk ({chunk}) < slots ({slots}); the JAX "
            "kernel's slot preamble reads past its block there, so the port "
            "refuses the combination")


def _check(fn: str, table, plan: GroupPlan, rows) -> None:
    """Raise on anything kernel 7 does not take; `fn` names the caller in
    errors."""
    V, C = table.shape
    N = plan.sids.shape[-1]
    dev = table.device
    if table.dtype not in _DTYPES:
        raise ValueError(f"{fn}: table dtype {table.dtype} is not float32 "
                         "or bfloat16")
    if rows.dtype not in (torch.float32, table.dtype):
        raise ValueError(f"{fn}: rows must be float32 or {table.dtype}, got "
                         f"{rows.dtype}")
    if rows.shape != (N, C):
        raise ValueError(f"{fn}: rows {tuple(rows.shape)} vs plan of {N} ids "
                         f"into width {C}")
    if plan.sids.dim() != 1:
        raise ValueError(f"{fn}: pass one step's plan (GroupPlan.step)")
    for name, t in (("table", table), ("rows", rows)) + tuple(
            zip(GroupPlan._fields, plan)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, table on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    for name, t in zip(GroupPlan._fields, plan):
        if t.dtype != torch.int32:
            raise ValueError(f"{fn}: plan.{name} must be int32")
    if plan.run_start.shape[-1] != N + 1 or plan.vis_run.shape[-1] != N + 1:
        raise ValueError(f"{fn}: plan.run_start and plan.vis_run must have "
                         "N+1 entries")


def _launch(table, plan: GroupPlan, rows) -> None:
    """Kernel 7 on one step's plan: the sorted ids, their source rows and
    the device's workspace."""
    _check("scatter_add_grmw", table, plan, rows)
    V, C = table.shape
    N = plan.sids.shape[-1]
    lib = _library()
    part, count = workspace(table.device, lib.w2b_group_rmw_partials(N, C),
                            lib.w2b_group_rmw_counters(N, C))
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.w2b_group_rmw(
        table.data_ptr(), rows.data_ptr(), plan.sids.data_ptr(),
        plan.order.data_ptr(), part.data_ptr(), count.data_ptr(), N, V, C,
        _DTYPES[table.dtype], _DTYPES[rows.dtype], stream)
    check_launch("w2b_group_rmw", err)


def scatter_add_grmw_planned(table: torch.Tensor, plan: GroupPlan,
                             rows: torch.Tensor, chunk: int = 128,
                             slots: int = 16) -> torch.Tensor:
    """Apply one step's group_plan: table[ids] += rows, in place.
    rows [N, C] in float32 or the table dtype, in the ids' original order."""
    _check_slots(chunk, slots)
    if table.device.type == "cpu":
        return scatter_add_grmw_plain(table, plan.sids,
                                      rows[plan.order.long()])
    if table.device.type != "cuda":
        raise ValueError("scatter_add_grmw runs on cpu (plain version) or "
                         f"cuda (kernel), not {table.device}")
    _launch(table, plan, rows)
    scatter_add_grmw_planned.launches += 1
    return table


scatter_add_grmw_planned.launches = 0


def scatter_add_grmw(table: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor, chunk: int = 128,
                     slots: int = 16) -> torch.Tensor:
    """table[ids] += rows in place (ids [N], rows [N, C]) via the sorted
    group-RMW kernel; builds the plan and applies it."""
    _check_slots(chunk, slots)
    plan = group_plan(ids, group_rows(table.dtype), chunk=chunk)
    return scatter_add_grmw_planned(table, plan, rows, chunk=chunk,
                                    slots=slots)
