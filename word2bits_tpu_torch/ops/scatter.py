"""The plain scatter-add of the parameter updates, and its duplicate-combining
and hot-row forms.

The counterparts of the JAX package's ops/scatter.py and of its XLA
scatters (`table.at[ids].add(rows.astype(table.dtype))`); they update the
table IN PLACE.  Float32 sums stay float32 (no TF32: the products below are
on 0/1 masks and run with `allow_tf32` off, as on the whole training path).

- `scatter_add`: every plain scatter-add of the training path.  XLA's
  scatter is deterministic, and so is this one: on the CPU it is
  `index_add_`, which adds in index order; on a CUDA tensor, where
  `index_add_`'s atomics add in arrival order (so the same seed would not
  give the same vectors), a stable sort of the ids and kernel 2
  (kernels/span_scatter.scatter_add_span_planned), which sums each id's
  rows in float32 in the sorted order and adds once.  Ids outside [0, V)
  (the drop SENTINEL, -1 padding) are dropped, as by XLA's mode="drop".
- `scatter_add_dedup` (`-dedup-block M`): blocks of M rows; inside a block
  the rows of equal ids are summed in float32 by a 0/1 mask product
  (`_combine_block`), rounded to the rows' dtype, and added once per id;
  blocks apply in order, so duplicates across blocks accumulate through the
  table as the plain scatter's do.
- `hot_slice_add` (`-hot-rows H` without `-hot-pallas`): every row whose id
  lies in [0, H) is summed in float32 into the head table[:H] (the vocab
  is count-sorted, so these are the frequent words), plus an optional
  dense float32 delta `extra`, with ONE rounding of the head.  The JAX
  package forms the sum as a one-hot [N, H] product; here it is a
  `scatter_add` into a float32 [H, C] buffer (the same sums in another
  order, deterministic, without the [N, H] operand).  Kernel 6
  (kernels/hot_pallas.py) computes the same function.
- `add_rows_where`: `table[ids[keep]] += rows[keep]` without a host sync.
- `scatter_add_sorted`: the plain scatter-add with the ids sorted first
  (the JAX package's probe of XLA's sorted-scatter path; no route of the
  trainer takes it).
"""

from __future__ import annotations

from typing import Optional

import torch

from word2bits_tpu_torch.kernels.span_scatter import (
    SENTINEL, scatter_add_span_planned, sort_plan)


def scatter_add(table: torch.Tensor, ids: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """table.at[ids].add(rows.astype(table.dtype), mode="drop"), in place:
    ids [N] (those outside [0, V) dropped), rows [N, C].  On a CUDA tensor
    a stable sort of the ids and kernel 2, which raises on what it does
    not take (there is no fallback)."""
    if table.device.type == "cpu":
        keep = (ids >= 0) & (ids < table.shape[0])
        return table.index_add_(0, ids[keep], rows[keep].to(table.dtype))
    if rows.dtype not in (torch.float32, table.dtype):
        rows = rows.to(table.dtype)   # kernel 2 rounds float32 rows itself
    return scatter_add_span_planned(table, sort_plan(ids.to(torch.int32)),
                                    rows.contiguous())


def add_rows_where(table: torch.Tensor, ids: torch.Tensor,
                   rows: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """table[ids[keep]] += rows[keep] in the table dtype, in place.  The
    dropped rows take the drop SENTINEL, so the call never asks the device
    how many rows it keeps."""
    return scatter_add(table, torch.where(keep, ids, SENTINEL), rows)


def _combine_block(ids: torch.Tensor, rows: torch.Tensor):
    """ids [..., M], rows [..., M, C] -> (ids2, combined): the first
    occurrence of each id within a block carries the float32 sum of all
    its block's equal-id rows, rounded to rows.dtype; every later duplicate
    gets the drop SENTINEL.  Leading dimensions batch blocks."""
    M = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]               # [..., M, M]
    lower = torch.ones((M, M), dtype=torch.bool,
                       device=ids.device).tril(-1)
    is_first = ~(eq & lower).any(dim=-1)
    w = (eq & is_first[..., :, None]).to(torch.float32)
    combined = torch.matmul(w, rows.to(torch.float32)).to(rows.dtype)
    ids2 = torch.where(is_first, ids, SENTINEL)
    return ids2, combined


def scatter_add_dedup(table: torch.Tensor, ids: torch.Tensor,
                      rows: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """table[ids] += rows in place (ids [N] in [0, V), rows [N, C]) with
    in-block duplicate combining; the JAX package's block semantics."""
    N, C = rows.shape
    nb = -(-N // block)
    pad = nb * block - N
    if pad:
        ids = torch.cat([ids, torch.full((pad,), SENTINEL, dtype=ids.dtype,
                                         device=ids.device)])
        rows = torch.cat([rows, rows.new_zeros((pad, C))])
    ids2, combined = _combine_block(ids.reshape(nb, block),
                                    rows.reshape(nb, block, C))
    for b in range(nb):
        scatter_add(table, ids2[b], combined[b])
    return table


def hot_slice_add(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                  hot_rows: int,
                  extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table[:H] = round(table[:H] + sum of the rows whose id is in [0, H)
    + extra), in place, the sum and the add in float32.

    ids [N] (ids < 0 or >= H contribute nothing; the caller scatters the
    cold rows), rows [N, C] float; extra optional [H, C] float.  At a bf16
    table the rows are rounded to bf16 before the sum (the JAX package's
    bf16 product operands).  H is capped at the table's rows."""
    H = min(int(hot_rows), table.shape[0])
    mm_dtype = torch.bfloat16 if table.dtype == torch.bfloat16 else rows.dtype
    acc = torch.zeros((H, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    # the [H, C] buffer drops every id outside [0, H)
    scatter_add(acc, ids, rows.to(mm_dtype).to(torch.float32))
    head = table[:H].to(torch.float32) + acc
    if extra is not None:
        head = head + extra.to(torch.float32)
    table[:H] = head.to(table.dtype)
    return table


def scatter_add_sorted(table: torch.Tensor, ids: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """table[ids] += rows in place, the rows rounded to the table dtype and
    added in the order of the stably sorted ids."""
    order = torch.argsort(ids, stable=True)
    return scatter_add(table, ids[order], rows[order])
