"""`band_usum_roofline`: the banded u-sum kernel's counts at the CBOW
cells' shapes, its pattern against the kernel's names as a trace prints
them, and its share read from a recorded trace."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import peaks, reference, work
from benchmark.cells import reader
from benchmark.kernels import band_usum, context, group_rmw, span_scatter
from benchmark.trace import Trace

# the kernel's two instantiations, as the profiler names them
NAMES = [f"void (anonymous namespace)::band_usum_kernel<{v}>(float const*, "
         "float const*, float const*, float*, float*, (anonymous "
         "namespace)::Shape)" for v in ("true", "false")]
OTHERS = ["void (anonymous namespace)::context_kernel<__nv_bfloat16>(...)",
          "void w2b::tile_scatter_kernel<w2b::TileCfg<32, 128, 4, 2, 256, "
          "false>, __nv_bfloat16, w2b::DenseRows<__nv_bfloat16, float, 4>, "
          "4, w2b::AddSum>(...)",
          "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x64x8_stage3_"
          "warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel"]


def _shape(B, D, tile=256):
    counts = np.concatenate([[0], np.maximum(5, (1e5 * np.arange(
        1, 1000, dtype=float) ** -1.05).astype(np.int64))])
    cfg = SimpleNamespace(batch_size=B, window=8, size=D, negative=24,
                          neg_sharing=64, neg_pool=1, fused_on=True,
                          dtype="bfloat16", sample=1e-3, banded_tile=tile,
                          bitlevel=1)
    return work.StepShape.of(cfg, counts, reference)


@pytest.mark.parametrize("B,D,mb,us", [(16384, 800, 106.1, 31.67),
                                       (8192, 200, 13.71, 4.09)])
def test_counts_at_the_cells_shapes(B, D, mb, us):
    flops, nbytes = band_usum.per_step(_shape(B, D))
    assert flops == 2 * B * 16 * D
    assert nbytes / 1e6 == pytest.approx(mb, abs=0.05)
    assert peaks.bound_s(flops, nbytes) * 1e6 == pytest.approx(us, abs=0.05)


def test_nothing_without_a_banded_step():
    assert band_usum.per_step(_shape(8192, 200, tile=0)) is None


def test_pattern_names_the_kernel_alone():
    tr = Trace(device=[(n, 0.0, 1.0) for n in NAMES + OTHERS], wall_s=2.0)
    assert [e[0] for e in tr.matching(band_usum.PATTERNS,
                                      band_usum.EXCLUDE)] == NAMES
    for k in (context, group_rmw, span_scatter):
        assert not {e[0] for e in tr.matching(k.PATTERNS, k.EXCLUDE)} & \
            set(NAMES)


def test_roofline_from_a_recorded_trace():
    us = 1e-6
    sh = _shape(16384, 800)
    tr = Trace(device=[(NAMES[0], 0.0, 50 * us), (OTHERS[0], 60 * us,
                                                  300 * us),
                       (NAMES[0], 400 * us, 450 * us)], wall_s=500 * us)
    ctx = SimpleNamespace(trace=tr, steps=2, shape=sh)
    want = 100 * peaks.bound_s(*band_usum.per_step(sh)) / (50 * us)
    assert reader("band_usum_roofline.wiki")(ctx) == pytest.approx(want)
    empty = SimpleNamespace(trace=Trace(device=[(OTHERS[0], 0.0, us)],
                                        wall_s=1.0), steps=2, shape=sh)
    assert reader("band_usum_roofline.wiki")(empty) is None
