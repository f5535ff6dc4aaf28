"""In-place RMW scatter-add: `table.at[ids].add(rows)`, the `-rmw-scatter`
capacity path's parameter update.

Kernel: `w2b_scatter_rmw` in csrc/group_rmw.cu, a CUDA C++ kernel for
sm_90a that replaces the JAX package's TPU kernel `scatter_add_rmw`
(kernels/scatter_pallas.py, `_rmw_kernel` via `_scatter_rmw`).  It keeps
the JAX numerics: each row is rounded to the table dtype, an id's
duplicates are summed in float32, the sum is rounded to the table dtype,
and the table gets ONE add in its dtype; ids outside [0, V) — the
0x7FFFFFF0 drop sentinel — are dropped; the update is in place, with no
table-sized temporary and no atomics.

The TPU kernel combines duplicates per `block` of rows (a mask product on
16-row groups) and runs the blocks in order, so an id held by two blocks
is added twice.  On the card blocks run at once; the port therefore shares
kernel 7's design (kernels/group_rmw.py): a sorted plan with ONE visit per
touched row group over the whole call, one CTA per visit, and the
duplicates combined over the whole call.  The two differ only in where the
table-dtype roundings fall; the tests state the tolerance.  Kernel 8 has
its own entry point, plain version and launch counter; its epilogue rounds
each id's sum before the add, where kernel 7 adds the float32 sum.

`block` and `slots` size the TPU kernel's blocks and DMA chains and have no
role on the card.  Unlike the JAX kernel, any V and any row width are
accepted: the table needs no padding.

Bound on the H100 (3.35 TB/s): bytes — the rows read once, each touched
table row read and written once, and the plan; the time is in PERF.md.

`scatter_add_rmw` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors, raising on what it does not take; there is no
fallback.  `scatter_add_rmw.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from word2bits_tpu_torch.kernels.group_rmw import (  # noqa: F401
    GroupPlan, group_plan, group_rows, launch_group_kernel)


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


def scatter_add_rmw_planned(table: torch.Tensor, plan: GroupPlan,
                            rows: torch.Tensor) -> torch.Tensor:
    """Apply a group_plan of the ids with kernel 8, in place: rows [N, C]
    in float32 or the table dtype, in the ids' original order."""
    if table.device.type == "cpu":
        return scatter_add_rmw_plain(table, plan.sids,
                                     rows[plan.order.long()])
    if table.device.type != "cuda":
        raise ValueError("scatter_add_rmw runs on cpu (plain version) or "
                         f"cuda (kernel), not {table.device}")
    launch_group_kernel("w2b_scatter_rmw", "scatter_add_rmw", table, plan,
                        rows)
    scatter_add_rmw.launches += 1
    return table


def scatter_add_rmw(table: torch.Tensor, ids: torch.Tensor,
                    rows: torch.Tensor, block: int = 512,
                    slots: int = 32) -> torch.Tensor:
    """table.at[ids].add(rows) in place: table [V, C] (any V), ids [N],
    rows [N, C] in float32 or the table dtype.  Builds the sorted plan
    (group_plan at the table dtype's group_rows) and applies it."""
    if block <= 0 or slots <= 0:
        raise ValueError(f"scatter_add_rmw: block ({block}) and slots "
                         f"({slots}) must be positive")
    if table.device.type == "cpu":
        return scatter_add_rmw_plain(table, ids, rows)
    plan = group_plan(ids, group_rows(table.dtype))
    return scatter_add_rmw_planned(table, plan, rows)


scatter_add_rmw.launches = 0
