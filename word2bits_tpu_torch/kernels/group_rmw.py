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

The plan is kernel 2's `sort_plan` (kernels/span_scatter.py), a pure
function of the ids batched over leading dimensions, so the training chunk
builds it once for all S steps: the stable sort of the ids and the source
row of each sorted slot.  Kernel 7 is the tiled template of
csrc/w2b_tiles.cuh (kernels 2, 3, 6 and 8 run it too, with their own
constants), which cuts the sorted stream into tiles and the columns into
groups, one CTA each, and sums a run cut by tile edges piece by piece
into float32 partials of the per-device workspace
(`span_scatter.workspace`), the CTA whose piece arrives last adding them
in tile order.  Kernel 8 (kernels/scatter_pallas.py) runs the same
template on the same plan with a rounding epilogue.

`chunk` and `slots` size the TPU kernel's blocks and DMA slots; they have no
role on the card and are kept for the signature, with the JAX kernel's one
hazard turned into an error: `chunk < slots` (its preamble reads past the
block there) raises.

Unlike the JAX kernel, the table needs no padding: any V and any row width.

Bound on the H100 (3.35 TB/s): bytes — the rows read once, each touched
table row read and written once, and the plan (~70 us at the flagship's
22,544 f32 rows x 1,600 columns); the kernel's time is in PERF.md.

The fused CBOW step hands it its update rows as
`span_scatter.RowParts`, the three buffers its phases wrote, which the
kernel reads in place (`w2b_group_rmw_parts`, counted also in
`span_scatter.launch_parts.launches`); the CPU materializes them.

`scatter_add_grmw_planned` / `scatter_add_grmw` run the plain version for
CPU tensors (an f32 `index_add_` into a temporary holding the touched rows,
then one cast-add) and launch the kernel for CUDA tensors, raising on what
it does not take (`_check`, shared with kernel 8); there is no fallback.
Every launch on a device uses the workspace shared with kernels 2, 3, 6
and 8, so two calls must not run at once on different streams; no path of
the port does that.
`scatter_add_grmw_planned.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library
from word2bits_tpu_torch.kernels.span_scatter import (
    PARTS_ARGTYPES, RowParts, SortPlan, check_sorted, launch_parts,
    scatter_add_span_plain, sort_plan, tile_constants, workspace)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    lib.w2b_group_rmw_parts.argtypes = PARTS_ARGTYPES
    lib.w2b_group_rmw_parts.restype = ctypes.c_int
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


def _check(fn: str, table, plan: SortPlan, rows) -> None:
    """Raise on anything kernels 7 and 8 do not take (check_sorted, and
    one row per sorted id); `fn` names the caller in errors."""
    check_sorted(fn, table, plan, rows)
    if rows.shape[0] != plan.sids.shape[0]:
        raise ValueError(f"{fn}: rows {tuple(rows.shape)} vs plan of "
                         f"{plan.sids.shape[0]} ids")


def _launch(table, plan: SortPlan, rows) -> None:
    """Kernel 7 on one step's plan: the sorted ids, their source rows (dense
    or RowParts) and the device's workspace."""
    lib = _library()
    if isinstance(rows, RowParts):
        launch_parts("scatter_add_grmw", lib.w2b_group_rmw_parts,
                     lib.w2b_group_rmw_partials, lib.w2b_group_rmw_counters,
                     table, plan, rows)
        return
    _check("scatter_add_grmw", table, plan, rows)
    V, C = table.shape
    N = plan.sids.shape[-1]
    part, count = workspace(table.device, lib.w2b_group_rmw_partials(N, C),
                            lib.w2b_group_rmw_counters(N, C))
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.w2b_group_rmw(
        table.data_ptr(), rows.data_ptr(), plan.sids.data_ptr(),
        plan.order.data_ptr(), part.data_ptr(), count.data_ptr(), N, V, C,
        _DTYPES[table.dtype], _DTYPES[rows.dtype], stream)
    check_launch("w2b_group_rmw", err)


def scatter_add_grmw_planned(table: torch.Tensor, plan: SortPlan,
                             rows: torch.Tensor | RowParts, chunk: int = 128,
                             slots: int = 16) -> torch.Tensor:
    """Apply one step's sort_plan: table[ids] += rows, in place.
    rows [N, C] in float32 or the table dtype, in the ids' original order,
    or the fused step's RowParts (materialized on the CPU)."""
    _check_slots(chunk, slots)
    if table.device.type == "cpu":
        if isinstance(rows, RowParts):
            rows = rows.materialize()
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
    return scatter_add_grmw_planned(table, sort_plan(ids), rows,
                                    chunk=chunk, slots=slots)
