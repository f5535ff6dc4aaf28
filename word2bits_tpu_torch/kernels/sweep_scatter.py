"""Swept scatter-add: `table[ids] += rows` through a per-(chunk, window)
placement plan, the fused chunk's `scatter_impl="sweep"` update.

Kernel: csrc/sweep_scatter.cu, a CUDA C++ kernel for sm_90a that replaces
the JAX package's TPU kernel (kernels/sweep_scatter.py, `_sweep_kernel` via
`_sweep_call`).  The JAX package keeps it as a measured negative behind
the span scatter (its config rejects `-scatter-impl sweep`, and so does the
port's); its fused chunk still reaches it, and so does the port's.

The plan (`sweep_plan`, plain PyTorch: one sort, searchsorted, cumsum) is
the JAX one: the sorted ids are laid out in `chunk`-slot blocks padded so
that no block crosses a `window`-row table window; each slot holds the
source row of one sorted id and its offset in the window (-1 pads).  The
contract is the JAX one too:

- rows are rounded to the table dtype first;
- within one block, the rows of one id are summed in float32;
- the table gets one add in its dtype per block, the blocks applied in
  order, so an id whose rows span two blocks is rounded twice, as on the
  TPU;
- ids >= V (the 0x7FFFFFF0 drop sentinel) and negative ids are dropped;
- the update is in place, with no atomics.

The kernel runs every block of the plan at once, one CTA each
(`csrc/sweep_scatter.cu` has the design): a block's runs of one offset are
found in the kernel; the run holding an id's first slot owns the id, and
where the id goes on into the next blocks of its window, the owner's CTA
sums each of those blocks' rows in parallel and then adds the sums to the
row in block order, each with its own rounding, so the table row is
written by one thread per column only.  The sums run in slot order, from
0, in the kernel and in the plain version alike, so the two are
bit-equal.  The first version (one CTA per window, its blocks one after
another) took 0.776 ms where `index_add_` of the same rows takes 0.043 ms
(NVIDIA H100 80GB HBM3, 700 W; PERF.md, which has the redesign's time).
The wrapper passes the plan's own arrays (slot rows, offsets, the window
of each block) and derives nothing new.  The JAX
entry point requires V % window == 0 and a row width that is a multiple of
128 (Mosaic tiles); the port takes any V, counting ceil(V / window)
windows with the last one partial, and any width: the table needs no
padding.

Bound on the H100 (3.35 TB/s): bytes — the rows and the plan read once,
each touched table row read and written once; the time is in PERF.md.

`scatter_add_sweep_planned` runs the plain version for CPU tensors and
launches the kernel for CUDA tensors, raising on what it does not take;
there is no fallback.  `scatter_add_sweep_planned.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 1024   # csrc/sweep_scatter.cu stages a block's slots in smem


class SweepPlan(NamedTuple):
    """Pure function of (ids, V, window, chunk): K blocks of `chunk`
    slots."""

    order: torch.Tensor      # [K*chunk] int32 source row per slot (N: pad)
    offs: torch.Tensor       # [K*chunk] int32 offset in the window (-1: pad)
    meta: torch.Tensor       # [K] int32 window of each block
    win_chunk: torch.Tensor  # [nwin+1] int32 first block of each window


def plan_slots(N: int, nwin: int, chunk: int) -> int:
    """Static block count: every touched window wastes < 1 block."""
    return N // chunk + min(nwin, N) + (1 if N % chunk else 0)


def sweep_plan(ids: torch.Tensor, V: int, window: int = 512,
               chunk: int = 128) -> SweepPlan:
    """The placement plan of ids [N] into a V-row table (the JAX
    sweep_plan, over ceil(V / window) windows)."""
    if window <= 0 or chunk <= 0:
        raise ValueError(f"sweep_plan: window ({window}) and chunk ({chunk}) "
                         "must be positive")
    if ids.dim() != 1:
        raise ValueError("sweep_plan takes one step's ids [N]")
    N = ids.shape[0]
    dev = ids.device
    nwin = -(-V // window)
    K = plan_slots(N, nwin, chunk)
    sids, order = torch.sort(ids.long(), stable=True)
    # window edges in the sorted stream; the last edge is V, so ids >= V
    # (and negative ids, before edge 0) fall in no window
    bounds = torch.clamp(torch.arange(nwin + 1, device=dev) * window, max=V)
    edges = torch.searchsorted(sids, bounds)                  # [nwin+1]
    cpw = (edges[1:] - edges[:-1] + chunk - 1) // chunk       # blocks/window
    win_chunk = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                           torch.cumsum(cpw, dim=0)])         # [nwin+1]
    pad_start = win_chunk * chunk
    cstart = torch.arange(K, device=dev) * chunk              # [K]
    meta = torch.clamp(torch.searchsorted(pad_start, cstart, right=True) - 1,
                       0, max(nwin - 1, 0))
    src0 = torch.clamp(edges[meta] + (cstart - pad_start[meta]), 0, N)
    lim = edges[meta + 1]
    live = cstart < pad_start[nwin]
    src = src0[:, None] + torch.arange(chunk, device=dev)[None, :]
    valid = live[:, None] & (src < lim[:, None])              # [K, chunk]
    srcc = torch.clamp(src, max=max(N - 1, 0))
    if N:
        g = torch.where(valid, order[srcc], N)
        offs = torch.where(valid, sids[srcc] - (meta * window)[:, None], -1)
    else:
        g = torch.full_like(src, N)
        offs = torch.full_like(src, -1)
    i32 = torch.int32
    return SweepPlan(order=g.reshape(-1).to(i32), offs=offs.reshape(-1).to(i32),
                     meta=meta.to(i32), win_chunk=win_chunk.to(i32))


def _runs(plan: SweepPlan, chunk: int):
    """(run of each slot, position in its run, start slot of each run) of
    the plan's runs: the slots of one block with one offset."""
    offs = plan.offs.long()
    valid = offs >= 0
    slot = torch.arange(offs.numel(), device=offs.device)
    start = valid.clone()
    start[1:] &= (offs[1:] != offs[:-1]) | (slot[1:] % chunk == 0)
    run = torch.cumsum(start, dim=0) - 1
    starts = slot[start]
    pos = slot - starts[run.clamp_min(0)]
    return run, pos, starts


def _apply_plain(table: torch.Tensor, plan: SweepPlan, rows: torch.Tensor,
                 window: int, chunk: int) -> torch.Tensor:
    """The plain version of one plan, in place: each run's rows, rounded to
    the table dtype, summed in float32 in slot order from 0; each run's sum
    added to its row with one rounding, an id's runs in block order."""
    C = table.shape[1]
    valid = plan.offs >= 0
    if not bool(valid.any()):
        return table
    run, pos, starts = _runs(plan, chunk)
    n_runs = starts.numel()
    acc = torch.zeros((n_runs, C), dtype=torch.float32, device=table.device)
    rows_t = rows.to(table.dtype).to(torch.float32)
    vrun, vpos = run[valid], pos[valid]
    vsrc = plan.order.long()[valid]
    for j in range(int(vpos.max()) + 1):
        sel = vpos == j                      # one slot of each long-enough run
        r = vrun[sel]
        acc[r] = acc[r] + rows_t[vsrc[sel]]
    blk = starts // chunk
    rid = (plan.meta.long()[blk] * window + plan.offs.long()[starts])
    # an id's runs are adjacent (sorted) and in block order: its j-th run
    # is applied in round j
    new_id = torch.ones(n_runs, dtype=torch.bool, device=table.device)
    new_id[1:] = rid[1:] != rid[:-1]
    idx = torch.arange(n_runs, device=table.device)
    first_of_id = torch.cummax(torch.where(new_id, idx, 0), dim=0).values
    rank = idx - first_of_id
    for j in range(int(rank.max()) + 1):
        sel = rank == j
        ids_j = rid[sel]
        table[ids_j] = (table[ids_j].to(torch.float32)
                        + acc[sel]).to(table.dtype)
    return table


def scatter_add_sweep_plain(table: torch.Tensor, ids: torch.Tensor,
                            rows: torch.Tensor, window: int = 512,
                            chunk: int = 128) -> torch.Tensor:
    """The plain PyTorch version, in place: sweep_plan, then the same sums
    as the kernel in the same order."""
    plan = sweep_plan(ids, table.shape[0], window, chunk)
    return _apply_plain(table, plan, rows, window, chunk)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("sweep_scatter").w2b_sweep_scatter
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(table, plan: SweepPlan, rows, window: int, chunk: int) -> None:
    V, C = table.shape
    nwin = -(-V // window)
    if table.dtype not in _DTYPES:
        raise ValueError(f"scatter_add_sweep: table dtype {table.dtype} is "
                         "not float32 or bfloat16")
    if rows.dtype not in (torch.float32, table.dtype):
        raise ValueError(f"scatter_add_sweep: rows must be float32 or "
                         f"{table.dtype}, got {rows.dtype}")
    if rows.dim() != 2 or rows.shape[1] != C:
        raise ValueError(f"scatter_add_sweep: rows {tuple(rows.shape)} into "
                         f"width {C}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"scatter_add_sweep: chunk {chunk} > {MAX_CHUNK} "
                         "(the kernel stages a block's slots in shared "
                         "memory)")
    if (plan.offs.numel() != plan.meta.numel() * chunk
            or plan.order.numel() != plan.offs.numel()
            or plan.win_chunk.numel() != nwin + 1):
        raise ValueError("scatter_add_sweep: the plan was built for another "
                         "table, window or chunk")
    for name, t in (("table", table), ("rows", rows)) + tuple(
            zip(SweepPlan._fields, plan)):
        if t.device != table.device:
            raise ValueError(f"scatter_add_sweep: {name} is on {t.device}, "
                             f"table on {table.device}")
        if not t.is_contiguous():
            raise ValueError(f"scatter_add_sweep: {name} must be contiguous")
    for name, t in zip(SweepPlan._fields, plan):
        if t.dtype != torch.int32:
            raise ValueError(f"scatter_add_sweep: plan.{name} must be int32")


def scatter_add_sweep_planned(table: torch.Tensor, plan: SweepPlan,
                              rows: torch.Tensor, window: int = 512,
                              chunk: int = 128) -> torch.Tensor:
    """Apply a sweep_plan of the ids with kernel 9, in place: rows [N, C]
    in float32 or the table dtype, in the ids' original order."""
    if table.device.type == "cpu":
        return _apply_plain(table, plan, rows, window, chunk)
    if table.device.type != "cuda":
        raise ValueError("scatter_add_sweep runs on cpu (plain version) or "
                         f"cuda (kernel), not {table.device}")
    _check(table, plan, rows, window, chunk)
    V, C = table.shape
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _kernel()(table.data_ptr(), rows.data_ptr(),
                    plan.order.data_ptr(), plan.offs.data_ptr(),
                    plan.meta.data_ptr(), plan.meta.numel(),
                    window, chunk, C, _DTYPES[table.dtype],
                    _DTYPES[rows.dtype], stream)
    check_launch("w2b_sweep_scatter", err)
    scatter_add_sweep_planned.launches += 1
    return table


scatter_add_sweep_planned.launches = 0


def scatter_add_sweep(table: torch.Tensor, ids: torch.Tensor,
                      rows: torch.Tensor, window: int = 512,
                      chunk: int = 128) -> torch.Tensor:
    """table[ids] += rows in place (ids [N], rows [N, C], any V and C) via
    the swept placement: builds the plan and applies it."""
    plan = sweep_plan(ids, table.shape[0], window, chunk)
    return scatter_add_sweep_planned(table, plan, rows, window, chunk)
