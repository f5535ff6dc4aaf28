"""Banded-block formulation of the CBOW step's two windowed sums.

Tile the batch into Nt blocks of `tile` centers; a tile's contexts span
only F = tile + 2W slab positions, so with a per-tile [tile, F] 0/1 mask M

  csum-tile  = M  @ q_window        ([tile, F] x [F, D]  per tile)
  du-window  = M^T @ cavge-tile     ([F, tile] x [tile, D] per tile)

and the du windows overlap-add by their 2W halo.  The two contractions are
plain batched products (`torch.bmm`), as the JAX package left them to XLA
outside any kernel; on the card the step takes the u-sum from the banded
kernel of kernels/band_usum.py instead, whose plain version is
`banded_usum`.  Same sums as the reference's per-(center, context) loops
(reference src/word2bits.cpp:431-449, :494-503) modulo float order.
"""

from __future__ import annotations

import torch


def pick_tile(B: int, W: int, requested: int) -> int:
    """Largest usable tile <= requested that divides B, with tile >= 2W
    (the overlap-add fold needs the halo to fit one tile)."""
    t = min(requested, B)
    while t >= max(2 * W, 1):
        if B % t == 0:
            return t
        t -= 1
    raise ValueError(f"no banded tile <= {requested} divides B={B} "
                     f"with tile >= 2W={2 * W}")


def build_banded_masks(slab_sents: torch.Tensor, shrink: torch.Tensor,
                       B: int, W: int, tile: int):
    """Per-tile banded context masks.

    Returns (M [Nt, tile, F] float32, win_idx [Nt, F] int64, valid [B] bool)
    with F = tile + 2W.  M[t, i, j] = 1 iff slab position t*tile + j is a
    context of center t*tile + i: inside the shrunk window (|o| <= W -
    shrink, o != 0 — reference src/word2bits.cpp:428-431), same sentence,
    both unpadded (:431-434)."""
    dev = slab_sents.device
    Nt = B // tile
    F = tile + 2 * W
    base = (torch.arange(Nt, device=dev) * tile)[:, None]
    win_idx = base + torch.arange(F, device=dev)[None, :]           # [Nt, F]
    sent_win = slab_sents[win_idx]                                  # [Nt, F]
    csent = slab_sents[W + base + torch.arange(tile, device=dev)[None, :]]
    valid = csent >= 0                                              # [Nt, tile]
    shrink3 = shrink.reshape(Nt, tile)
    # offset of window column j relative to center i: o = j - i - W
    o = (torch.arange(F, device=dev)[None, None, :]
         - torch.arange(tile, device=dev)[None, :, None] - W)
    in_win = (o.abs() <= (W - shrink3)[:, :, None]) & (o != 0)
    m = (in_win & (sent_win[:, None, :] == csent[..., None])
         & valid[..., None] & (sent_win[:, None, :] >= 0))
    return m.to(torch.float32), win_idx, valid.reshape(B)


def _tile_windows(x: torch.Tensor, Nt: int, tile: int, W: int):
    """[B+2W, ...] -> [Nt, tile+2W, ...] overlapping tile windows, as a
    strided view (no copy)."""
    F = tile + 2 * W
    w = x[:(Nt - 1) * tile + F].unfold(0, F, tile)   # [Nt, ..., F]
    return w.movedim(-1, 1)


def banded_context(q_slab: torch.Tensor, q_sq, M: torch.Tensor, B: int):
    """(csum [B, D], sq_sum [B] or None, cw [B]) via one batched product.

    q_sq=None skips the squared-norm column (reg == 0: its only consumer is
    the -reg*||q||^2 loss term)."""
    D = q_slab.shape[1]
    Nt, tile, F = M.shape
    W = (F - tile) // 2
    if q_sq is None:
        aug = _tile_windows(q_slab, Nt, tile, W)                    # [Nt, F, D]
    else:
        aug = _tile_windows(torch.cat([q_slab, q_sq[:, None]], dim=1),
                            Nt, tile, W)                            # [Nt, F, D+1]
    out = torch.bmm(M, aug)
    csum = out[..., :D].reshape(B, D)
    sq_sum = None if q_sq is None else out[..., D].reshape(B)
    cw = M.sum(dim=2).reshape(B)
    return csum, sq_sum, cw


def banded_usum(M: torch.Tensor, cavge: torch.Tensor, B: int, W: int):
    """(du_slab [B+2W, D], cnt [B+2W]) — the transpose contraction with
    overlap-add of each tile's 2W-halo tail onto the next tile's head.
    `M` must already carry any per-center weighting (pass M * af)."""
    Nt, tile, F = M.shape
    D = cavge.shape[1]
    cav3 = cavge.reshape(Nt, tile, D)
    duw = torch.bmm(M.transpose(1, 2), cav3)                        # [Nt, F, D]
    cntw = M.sum(dim=1)                                             # [Nt, F]

    body, tail = duw[:, :tile], duw[:, tile:]                       # halo = 2W
    # tile t's tail covers slab rows [(t+1)*tile, (t+1)*tile + 2W)
    body = body.clone()
    body[1:, :2 * W] += tail[:-1]
    du_slab = torch.cat([body.reshape(B, D), tail[-1]])

    cbody, ctail = cntw[:, :tile].clone(), cntw[:, tile:]
    cbody[1:, :2 * W] += ctail[:-1]
    cnt = torch.cat([cbody.reshape(B), ctail[-1]])
    return du_slab, cnt
