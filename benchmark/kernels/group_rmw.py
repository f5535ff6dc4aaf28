"""Kernel 7, the sorted group read-modify-write scatter
(word2bits_tpu_torch/csrc/group_rmw.cu, the tile template
`tile_scatter_kernel` with grmw's TileCfg<32, 128, 4, 2, 256>): one call a
step on the fused capacity engine (-scatter-impl grmw) for the slab rows
and the negatives' v rows.  Bytes: chip_smoke.py's count
(work.grmw_bytes) with the touched rows expected from the cell's counts."""

from benchmark import work

PATTERNS = [r"tile_scatter_kernel<w2b::TileCfg<32, 128, 4, 2, 256\b"]
EXCLUDE = []


def per_step(shape: work.StepShape):
    if not shape.fused:
        return None
    N = shape.n_slab + shape.n_negs
    C = 2 * shape.D
    return N * C, work.grmw_bytes(N, C, shape.rows_all, shape.elt)
