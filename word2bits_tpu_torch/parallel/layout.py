"""Balanced hot-head vocab layout for the dense-hot sharded step.

The counterpart of the JAX package's parallel/layout.py (integer maps,
bit-equal to it).  The vocabulary is count-sorted, so the dense-hot
negative stratum scores every center against the rows with global id < H.
Under contiguous row sharding (owner = id // Vs) those H rows all live on
vocab shard 0, and every other shard runs the same [B, H] products on
rows of weight zero.  This layout splits the hot head across the vocab
shards:

  layout slot map (global id g, nv shards, Hp = H rounded up to nv):
    g <  Hp : owner = g // (Hp/nv),        local = g % (Hp/nv)
    g >= Hp : owner = (g-Hp) // Cs,        local = Hp/nv + (g-Hp) % Cs
              where Cs = (Vp - Hp) / nv

so shard j's leading Hp/nv local rows are the hot sub-range
[j*Hp/nv, (j+1)*Hp/nv) and the dense-hot products shrink to [B, Hp/nv] a
shard.  Cold ownership stays contiguous, so the collectives do not
change; the step is the same sums, only the rows' placement moves.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch


class HotLayout(NamedTuple):
    """Static description of the interleaved hot-head placement."""

    hot_pad: int         # hot boundary rounded up to a multiple of nv (Hp)
    hot_per_shard: int   # Hp // nv
    cold_per_shard: int  # (Vp - Hp) // nv
    nv: int

    def owner_local(self, ids: torch.Tensor):
        """Piecewise (owner shard, local row) map of global ids."""
        Hp, Hs, Cs = self.hot_pad, self.hot_per_shard, self.cold_per_shard
        is_hot = ids < Hp
        c = torch.clamp_min(ids - Hp, 0)
        return (torch.where(is_hot, ids // Hs, c // Cs),
                torch.where(is_hot, ids % Hs, Hs + c % Cs))

    def ranges(self, shard: int) -> List[Tuple[int, int]]:
        """The global id ranges shard `shard` holds, in local row order."""
        Hs, Cs = self.hot_per_shard, self.cold_per_shard
        return [(shard * Hs, (shard + 1) * Hs),
                (self.hot_pad + shard * Cs, self.hot_pad + (shard + 1) * Cs)]


def make_hot_layout(vocab_size_padded: int, nv: int,
                    hot_rows: int) -> HotLayout:
    """The layout of `hot_rows` hot ids over `nv` vocab shards.

    hot_rows is rounded up to a multiple of nv (the tail [hot_rows, Hp)
    is laid out as hot with zero dense weight: pad_hot_weights).  Needs
    Hp < Vp, so every shard keeps a nonempty cold block."""
    if vocab_size_padded % nv:
        raise ValueError(f"vocab {vocab_size_padded} not divisible by {nv}")
    Hp = -(-hot_rows // nv) * nv
    if Hp <= 0:
        raise ValueError("hot layout requires hot_rows > 0")
    if Hp >= vocab_size_padded:
        raise ValueError(
            f"hot head {Hp} (rounded to {nv}) must leave a nonempty cold "
            f"block in a {vocab_size_padded}-row padded vocab")
    return HotLayout(hot_pad=Hp, hot_per_shard=Hp // nv,
                     cold_per_shard=(vocab_size_padded - Hp) // nv, nv=nv)


def pad_hot_weights(hot_w, layout: HotLayout):
    """Zero-extend the dense hot weights (numpy or tensor) to the layout's
    padded boundary."""
    pad = layout.hot_pad - hot_w.shape[0]
    if pad < 0:
        raise ValueError("hot_w longer than the layout's hot head")
    if isinstance(hot_w, torch.Tensor):
        return torch.cat([hot_w, hot_w.new_zeros(pad)])
    if pad == 0:
        return np.asarray(hot_w)
    return np.concatenate([np.asarray(hot_w), np.zeros(pad, hot_w.dtype)])


def layout_order(layout: HotLayout, vocab_size_padded: int) -> np.ndarray:
    """Index array, layout slot -> global id (length Vp): x[layout_order]
    places a (Vp, D) table in layout order."""
    Hp, Hs, Cs, nv = layout
    order = np.empty(vocab_size_padded, np.int64)
    for j in range(nv):
        base = j * (Hs + Cs)
        order[base:base + Hs] = np.arange(j * Hs, (j + 1) * Hs)
        order[base + Hs:base + Hs + Cs] = Hp + np.arange(j * Cs, (j + 1) * Cs)
    return order


def _order_for(x, layout: HotLayout):
    order = layout_order(layout, x.shape[0])
    if isinstance(x, torch.Tensor):
        return torch.from_numpy(order).to(x.device)
    return order


def to_layout(x, layout: HotLayout):
    """Rows of a padded (Vp, ...) array (numpy or tensor) in layout order."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return x[_order_for(x, layout)]


def from_layout(x, layout: HotLayout):
    """Inverse of to_layout: the rows back in global order."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    order = _order_for(x, layout)
    out = torch.empty_like(x) if isinstance(x, torch.Tensor) \
        else np.empty_like(x)
    out[order] = x
    return out
