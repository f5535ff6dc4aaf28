"""In-place RMW scatter-add: `table.at[ids].add(rows)`, the `-rmw-scatter`
capacity path's parameter update.

Kernel: `w2b_scatter_rmw` in csrc/group_rmw.cu, a CUDA C++ kernel for
sm_90a that replaces the JAX package's TPU kernel `scatter_add_rmw`
(kernels/scatter_pallas.py, `_rmw_kernel` via `_scatter_rmw`).  It keeps
the JAX numerics: each row is rounded to the table dtype, an id's
duplicates are summed in float32, the sum is rounded to the table dtype,
and the table gets ONE add in its dtype; ids outside [0, V) — the
0x7FFFFFF0 drop sentinel — are dropped; the update is in place, with no
table-sized temporary and no atomics on the table or a sum.

The TPU kernel combines duplicates per `block` of rows (a mask product on
16-row groups) and runs the blocks in order, so an id held by two blocks
is added twice.  On the card blocks run at once; the port combines the
duplicates over the whole call instead, on kernel 7's design
(kernels/group_rmw.py): the tiled sorted scatter-add of csrc/w2b_tiles.cuh,
whose tiles of the sorted stream and groups of columns run one CTA each,
all at once, a run cut by tile edges (the Zipf head) summed piece by piece
into float32 partials of the per-device workspace (`span_scatter.workspace`)
and added in tile order.  Its epilogue rounds each id's whole sum to the
table dtype before the add, where kernel 7 adds the float32 sum.  The two
JAX and port versions differ only in where the table-dtype roundings fall;
the tests state the tolerance.  Kernel 8 reads the sorted ids and their
source rows alone, so `scatter_add_rmw`, which the step calls twice, builds
only those: one stable sort of the ids (span_scatter.sort_plan).

`block` and `slots` size the TPU kernel's blocks and DMA chains and have no
role on the card.  Unlike the JAX kernel, any V and any row width are
accepted: the table needs no padding.

Bound on the H100 (3.35 TB/s): bytes — the rows, the sorted ids and their
source rows read once, each touched table row read and written once; the
time is in PERF.md.

`scatter_add_rmw` / `scatter_add_rmw_planned` run the plain version for
CPU tensors and launch the kernel for CUDA tensors, raising on what it does
not take (kernel 7's `_check`); there is no fallback.  Its launches share
the workspace of kernels 2, 3, 6 and 7, so two calls must not run at once
on different streams; no path of the port does that.
`scatter_add_rmw.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from word2bits_tpu_torch.kernels._build import check_launch
from word2bits_tpu_torch.kernels.group_rmw import _DTYPES, _check, _library
from word2bits_tpu_torch.kernels.span_scatter import (SortPlan, sort_plan,
                                                      tile_constants,
                                                      workspace)


def scatter_add_rmw_plain(table: torch.Tensor, ids: torch.Tensor,
                          rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, in place: each id's rows, rounded to the
    table dtype, summed in float32 into a temporary holding only the
    touched rows; each sum rounded to the table dtype and added once."""
    V, C = table.shape
    keep = (ids >= 0) & (ids < V)
    touched, slot = torch.unique(ids[keep].long(), return_inverse=True)
    acc = torch.zeros((touched.numel(), C), dtype=torch.float32,
                      device=table.device)
    acc.index_add_(0, slot, rows[keep].to(table.dtype).to(torch.float32))
    table[touched] = (table[touched].to(torch.float32)
                      + acc.to(table.dtype).to(torch.float32)
                      ).to(table.dtype)
    return table


def tile_config() -> dict:
    """Kernel 8's tile constants, as built."""
    return tile_constants(_library().w2b_scatter_rmw_config)


def scatter_add_rmw_planned(table: torch.Tensor, plan: SortPlan,
                            rows: torch.Tensor) -> torch.Tensor:
    """Apply a sort_plan of the ids with kernel 8, in place: rows [N, C]
    in float32 or the table dtype, in the ids' original order."""
    if table.device.type == "cpu":
        return scatter_add_rmw_plain(table, plan.sids,
                                     rows[plan.order.long()])
    if table.device.type != "cuda":
        raise ValueError("scatter_add_rmw runs on cpu (plain version) or "
                         f"cuda (kernel), not {table.device}")
    _check("scatter_add_rmw", table, plan, rows)
    V, C = table.shape
    N = plan.sids.shape[0]
    lib = _library()
    part, count = workspace(table.device, lib.w2b_scatter_rmw_partials(N, C),
                            lib.w2b_scatter_rmw_counters(N, C))
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.w2b_scatter_rmw(
        table.data_ptr(), rows.data_ptr(), plan.sids.data_ptr(),
        plan.order.data_ptr(), part.data_ptr(), count.data_ptr(), N, V, C,
        _DTYPES[table.dtype], _DTYPES[rows.dtype], stream)
    check_launch("w2b_scatter_rmw", err)
    scatter_add_rmw.launches += 1
    return table


def scatter_add_rmw(table: torch.Tensor, ids: torch.Tensor,
                    rows: torch.Tensor, block: int = 512,
                    slots: int = 32) -> torch.Tensor:
    """table.at[ids].add(rows) in place: table [V, C] (any V), ids [N],
    rows [N, C] in float32 or the table dtype.  Sorts the ids (sort_plan)
    and applies them."""
    if block <= 0 or slots <= 0:
        raise ValueError(f"scatter_add_rmw: block ({block}) and slots "
                         f"({slots}) must be positive")
    if table.device.type == "cpu":
        return scatter_add_rmw_plain(table, ids, rows)
    return scatter_add_rmw_planned(table, sort_plan(ids), rows)


scatter_add_rmw.launches = 0
