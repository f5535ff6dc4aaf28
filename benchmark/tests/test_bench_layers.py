"""The per-layer arithmetic on a recorded list of profiler events, and the
kernels' byte counts at chip_smoke.py's shapes against PERF.md's."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import peaks, reference, work
from benchmark.cells import reader
from benchmark.kernels import context, group_rmw, span_scatter
from benchmark.trace import Trace

SPAN = ("void w2b::tile_scatter_kernel<w2b::TileCfg<64, 128, 4, 2, 128, "
        "false>, __nv_bfloat16, w2b::DenseRows<__nv_bfloat16, float, 4>, 4, "
        "w2b::AddSum>(...)")
GRMW = SPAN.replace("TileCfg<64, 128, 4, 2, 128", "TileCfg<32, 128, 4, 2, 256")
CTX = "void context_kernel<__nv_bfloat16>(...)"
SORT = "void at::native::radix_sort_kernel<int>(...)"


class Ctx:
    def __init__(self, trace, steps, shape=None):
        self.trace, self.steps, self.shape = trace, steps, shape


def recorded() -> Trace:
    # a 10 ms span of 2 steps: 1 ms of kernel 1, 0.5 of the sort overlapping
    # a copy, 2 ms of kernel 2, 1 ms of kernel 7; idle between
    us = 1e-6
    dev = [(CTX, 0 * us, 1000 * us), (SORT, 2000 * us, 2500 * us),
           ("Memcpy HtoD (Pageable -> Device)", 2400 * us, 2600 * us),
           (SPAN, 3000 * us, 5000 * us), (GRMW, 8000 * us, 9000 * us)]
    host = [("aten::sort", 1500 * us, 2700 * us),
            ("aten::item", 5000 * us, 8000 * us),
            ("aten::_local_scalar_dense", 5500 * us, 7900 * us)]
    return Trace(device=dev, host=host, wall_s=10000 * us)


def test_busy_idle_and_launches():
    tr = recorded()
    assert tr.busy_s() == pytest.approx(4600e-6)
    ctx = Ctx(tr, 2)
    assert reader("device_idle_pct.x")(ctx) == pytest.approx(54.0)
    assert reader("device_us_per_step.x")(ctx) == pytest.approx(2300.0)
    assert reader("launches_per_step.x")(ctx) == pytest.approx(2.5)
    # the sort alone is not the port's; the copy is not a kernel
    assert reader("plain_ops_us_per_step.x")(ctx) == pytest.approx(250.0)


def test_idle_gaps_named_by_the_host_op():
    gaps = dict(recorded().idle_gaps())
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(3000e-6)
    assert gaps["aten::sort"] == pytest.approx(1000e-6)
    assert gaps["host outside any op"] == pytest.approx(400e-6)
    top = recorded().top_device_ops()
    assert top[0] == [SPAN, pytest.approx(2000e-6)]


def test_nothing_to_read_gives_nothing():
    empty = Ctx(Trace(wall_s=1.0), 10)
    for m in ("device_idle_pct.x", "step_mfu.x", "launches_per_step.x",
              "context_roofline.x", "span_scatter_roofline.x"):
        assert reader(m)(empty) is None
    assert reader("device_idle_pct.x")(Ctx(None, 10)) is None


def _shape(fused=True, G=64, P=2, elt=2, B=8192, tile=256):
    """A step of CBOW's module, its negatives shared by tiles of G centers
    (G=0: per center), from flags like the program's configuration's."""
    counts = np.concatenate([[0], np.maximum(5, (1e5 * np.arange(
        1, 1000, dtype=float) ** -1.05).astype(np.int64))])
    cfg = SimpleNamespace(batch_size=B, window=8, size=200, negative=24,
                          neg_sharing=G, neg_pool=P, fused_on=fused,
                          dtype="bfloat16" if elt == 2 else "float32",
                          sample=1e-3, banded_tile=tile, bitlevel=1)
    return work.StepShape.of(cfg, counts, reference)


def test_roofline_and_step_mfu_from_the_trace():
    sh = _shape()
    ctx = Ctx(recorded(), 2, sh)
    flops, nbytes = span_scatter.per_step(sh)
    want = 100 * peaks.bound_s(flops, nbytes) / 1000e-6
    assert reader("span_scatter_roofline.x")(ctx) == pytest.approx(want)
    flops, nbytes = context.per_step(sh)
    want = 100 * peaks.bound_s(flops, nbytes) / 500e-6
    assert reader("context_roofline.x")(ctx) == pytest.approx(want)
    mfu = reader("step_mfu.x")(ctx)
    assert mfu == pytest.approx(100 * peaks.bound_s(
        sh.step_flops(), sh.step_bytes()) / 5000e-6)
    assert 0 < mfu < 100


def test_context_bytes_match_perf_md():
    # PERF.md section 6, kernel 1: 35.4 MB at D = 200, B = 8192 and
    # 229.3 MB at D = 800, B = 16384 (bf16 rows, tile 256, W = 8)
    assert work.context_bytes(8192, 200, 8, 256, 2) / 1e6 == \
        pytest.approx(35.4, abs=0.05)
    assert work.context_bytes(16384, 800, 8, 256, 2) / 1e6 == \
        pytest.approx(229.3, abs=0.05)


def _smoke_ids(seed, V, n_slab, n_neg, n_sentinel=64):
    """chip_smoke.py's _step_ids: its touched-row count U."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, V + 1, dtype=np.float64) ** -1.05
    p /= p.sum()
    p_kept = p * np.minimum((np.sqrt(p / 1e-3) + 1.0) * 1e-3 / p, 1.0)
    p_neg = p ** 0.75
    ids = np.concatenate([rng.choice(V, n_slab, p=p_kept / p_kept.sum()),
                          rng.choice(V, n_neg, p=p_neg / p_neg.sum())])
    ids[rng.choice(ids.size, n_sentinel, replace=False)] = -1
    return np.unique(ids[ids >= 0]).size


def test_span_bytes_match_perf_md():
    # PERF.md section 6, kernel 2: 34.9 MB for 14,352 float32 rows into
    # [70,000, 400] bf16 (chip_smoke.py check_span, seed 0)
    U = _smoke_ids(0, 70_000, 8192 + 16, 14_352 - 8192 - 16)
    assert work.span_bytes(14_352, 400, U, 2) / 1e6 == \
        pytest.approx(34.9, abs=0.05)


def test_grmw_bytes_match_perf_md():
    # PERF.md section 6, kernel 7: 235.2 MB for 22,544 float32 rows into
    # [3,699,941, 1,600] bf16 (chip_smoke.py check_grmw, seed 7)
    U = _smoke_ids(7, 3_699_941, 16384 + 16, 6144)
    assert work.grmw_bytes(22_544, 1600, U, 2) / 1e6 == \
        pytest.approx(235.2, abs=0.05)


def test_expected_distinct_rows():
    p = np.full(100, 0.01)
    assert work.expected_distinct((p, 1)) == pytest.approx(1.0)
    assert work.expected_distinct((p, 100)) == pytest.approx(
        100 * (1 - 0.99 ** 100))
    sh = _shape(fused=False, G=0, P=1, elt=4, B=256, tile=0)
    assert sh.n_negs == 256 * 24 and sh.rows_v <= 256 + 256 * 24
    assert context.per_step(sh) is None and group_rmw.per_step(sh) is None
