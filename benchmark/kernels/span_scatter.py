"""Kernel 2, the sorted span scatter (word2bits_tpu_torch/csrc/
span_scatter.cu, the tile template `tile_scatter_kernel` with span's
TileCfg<64, 128, 4, 2, 128>): on the fused engine one call a step for the
slab rows and the negatives' v rows (-scatter-impl span); on split tables
with the `add` route (ops/scatter.scatter_add: a stable sort, then the
kernel) one call for v (centers and negatives) and one for u (the slab).
Bytes: chip_smoke.py's count (work.span_bytes) with the touched rows
expected from the cell's unigram counts."""

from benchmark import work

PATTERNS = [r"tile_scatter_kernel<w2b::TileCfg<64, 128, 4, 2, 128\b"]
EXCLUDE = [r"Rank1"]


def per_step(shape: work.StepShape):
    D, e = shape.D, shape.elt
    if shape.fused:
        N = shape.n_slab + shape.n_negs
        nbytes = work.span_bytes(N, 2 * D, shape.rows_all, e)
        return N * 2 * D, nbytes
    Nv, Nu = shape.B + shape.n_negs, shape.n_slab
    nbytes = (work.span_bytes(Nv, D, shape.rows_v, e)
              + work.span_bytes(Nu, D, shape.rows_slab, e))
    return (Nv + Nu) * D, nbytes
