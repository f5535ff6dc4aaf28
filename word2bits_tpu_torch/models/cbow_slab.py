"""Slab-step building blocks shared by the fused-table step.

A batch of B *consecutive* centers reuses the same B+2W corpus positions as
contexts, so one slab gather serves every context row.  Negatives are
shared across strided tiles of G centers (center b joins tile b % T), and
with P pools per tile center g uses only pool g % P.  The split-table
`slab_step` itself is not ported yet; the fused step
(models/cbow_fused.py) uses these helpers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SlabInputs(NamedTuple):
    """Deterministic per-step inputs (randomness drawn by the chunk, or
    injected by a test)."""

    slab_tokens: torch.Tensor   # int [B+2W] — corpus ids, -1 padding
    slab_sents: torch.Tensor    # int [B+2W] — sentence ids, -1 padding
    shrink: torch.Tensor        # int [B] — window shrink b in [0, W)
    neg_ids: torch.Tensor       # int [B//G, P*K] shared negatives


def to_tiles(x: torch.Tensor, T: int, G: int) -> torch.Tensor:
    """[B, ...] -> [T, G, ...], STRIDED: tile t holds centers t, t+T, t+2T…"""
    return x.reshape((G, T) + tuple(x.shape[1:])).transpose(0, 1)


def from_tiles(x: torch.Tensor, B: int) -> torch.Tensor:
    """Inverse of to_tiles."""
    return x.transpose(0, 1).reshape((B,) + tuple(x.shape[2:]))


def pool_mask(G: int, K: int, P: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """[G, P*K] mask: center g of a tile uses only negative pool g % P."""
    pool_of_neg = torch.arange(P * K, device=device) // K
    pool_of_ctr = torch.arange(G, device=device) % P
    return (pool_of_ctr[:, None] == pool_of_neg[None, :]).to(dtype)
