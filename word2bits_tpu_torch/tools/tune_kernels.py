"""Time build variants of the score kernel (5) and of the tiled scatters
(6, 7 and 8) side by side on the card, at the shapes of the paths that
run them.

    python3 -m word2bits_tpu_torch.tools.tune_kernels \
        [--kernel score|grmw|hot|rmw|all]

Each variant is csrc/score.cu, csrc/group_rmw.cu or csrc/hot_slice.cu
built with `-D` overrides of its constants (one nvcc per variant, all at
once), loaded beside the others and called through its C entry point:

  score  CTA threads (W2B_SCORE_THREADS) x the unrolling of the product
         loops (W2B_SCORE_UNROLL) x the cluster size, CTAs a tile (a launch
         argument), at the shipped shape: T = 128 tiles
         of G = 64 centers sharing P*K = 48 negatives (P = 2), D = 200,
         float32, bitlevel 1;
  grmw   kernel 7's tile constants of csrc/w2b_tiles.cuh (W2B_GRMW_L,
         _THREADS, _SUB, _IB, _GROUP), at the flagship step: 22,544
         float32 rows of 1,600 columns (subsampled Zipf(1.05) slab ids,
         unigram^0.75 negatives, 64 drop sentinels) into a 3,699,941 x
         1,600 bf16 table;
  hot    kernel 6's (W2B_HOT_*), at chip_smoke.py's [hotk] shape: one
         step's 8,208 float32 slab rows (subsampled Zipf(1.05) ids) into
         the H = 2,048 head of a 70,000 x 400 bf16 table, without and
         with a float32 `extra` (timed both ways);
  rmw    kernel 8's (W2B_RMW_*), at [rmwk]'s shape: one step's two calls,
         16,400 slab and 6,144 negative float32 rows (64 drop sentinels
         each) into a 3,699,941 x 1,600 bf16 table.

Builds that stop after a phase (W2B_SCORE_STOP, W2B_TILE_STOP) are only
timed.  Every
other variant is first held against the plain version (score: atol 1e-5 +
rtol 1e-4 on rows with no pair within 2e-5 of a LUT edge; grmw and hot:
atol 1e-5 + rtol 2^-7 on the touched rows; rmw: two bf16 roundings,
2^-6 (|want| + A) + 1e-6 with A the per-id sum of |rows|) and run twice
for bit-equal outputs, then timed with CUDA events over 20 launches queued
behind a sleep kernel.  Prints one line per variant, the card's name and
power limit first.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

SEED = 0
SCORE_THREADS = (256, 512)
SCORE_CLUSTERS = (1, 2, 4)
SCORE_UNROLL = (1, 4)
# builds of the kept constants that return after phase 1 (staging), 2
# (partial scores and their exchange) or 3 (g and the loss)
SCORE_STOPS = (1, 2, 3)
# (L, THREADS, SUB, IB, GROUP); the first is kernel 2's own
GRMW_VARIANTS = ((64, 128, 4, 2, 128), (64, 128, 4, 2, 256),
                 (64, 256, 4, 2, 256), (32, 128, 4, 2, 256),
                 (32, 128, 4, 2, 512), (128, 256, 4, 2, 128),
                 (64, 256, 4, 2, 128), (64, 128, 4, 4, 128),
                 (64, 128, 2, 2, 128), (64, 128, 8, 2, 128),
                 (64, 128, 4, 1, 256), (64, 128, 4, 2, 400),
                 (32, 256, 4, 2, 800), (64, 256, 4, 4, 256))
GRMW_NAMES = ("L", "THREADS", "SUB", "IB", "GROUP")
# kernel 6's (L, THREADS, SUB, IB, GROUP); the first is kernel 2's own
HOT_VARIANTS = ((64, 128, 4, 2, 128), (32, 128, 2, 1, 128),
                (32, 128, 2, 2, 128), (64, 256, 4, 1, 128),
                (64, 256, 4, 2, 128), (64, 256, 2, 2, 128),
                (64, 512, 4, 1, 128), (64, 512, 2, 1, 128),
                (128, 512, 4, 1, 128), (32, 128, 2, 2, 32),
                (32, 128, 4, 2, 32), (32, 128, 2, 1, 32),
                (32, 128, 2, 2, 64), (64, 256, 2, 2, 64),
                (64, 256, 4, 2, 64), (32, 256, 2, 1, 64),
                (64, 128, 2, 4, 64), (32, 128, 2, 4, 128))
# kernel 8's; the first is kernel 7's own
RMW_VARIANTS = ((32, 128, 4, 2, 256), (32, 128, 4, 2, 512),
                (32, 128, 4, 4, 512), (32, 256, 4, 2, 512),
                (32, 128, 2, 2, 512), (32, 128, 2, 4, 512),
                (64, 256, 4, 2, 512), (32, 256, 4, 1, 512),
                (32, 128, 4, 1, 512), (32, 256, 4, 2, 800),
                (32, 128, 4, 2, 800), (64, 128, 4, 2, 256),
                (32, 128, 4, 2, 128), (64, 512, 4, 2, 512))
# builds of kernel 6's kept constants that return after phase 1 (staging,
# the runs), 2 (step 1: the chunks) or 3 (step 2: the longer runs)
TILE_STOPS = (1, 2, 3)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over reps launches queued behind a sleep
    kernel (the host's issue time leaves no gap on the card)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    while True:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued or cycles >= 320_000_000:
            return start.elapsed_time(stop) / reps
        cycles *= 4


def _build(name: str, variants):
    """{variant: CDLL} of csrc/<name>.cu, one nvcc per define set, all at
    once; a variant that does not build is reported and left out."""
    from word2bits_tpu_torch.kernels import _build as B
    started = [(v, d, B._start_build(name, defines=d)) for v, d in variants]
    libs = {}
    for v, d, p in started:
        try:
            B._finish_build(name, p)
        except RuntimeError as e:
            print(f"[tune {name}] {v} does not build: "
                  f"{str(e).splitlines()[1][:160]}")
            continue
        libs[v] = ctypes.CDLL(str(B._library_path(name, d)))
    return libs


def tune_score(dev) -> None:
    from word2bits_tpu_torch.kernels.score_pallas import (
        quantized_scores_plain)
    from word2bits_tpu_torch.ops.quantize import quantize
    libs = _build("score", [
        ((n, u, 0), (f"W2B_SCORE_THREADS={n}", f"W2B_SCORE_UNROLL={u}"))
        for n in SCORE_THREADS for u in SCORE_UNROLL] + [
        ((512, 4, s), (f"W2B_SCORE_STOP={s}",)) for s in SCORE_STOPS])
    T, G, PK, P, D = 128, 64, 48, 2, 200
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    cavg3 = torch.randn((T, G, D), generator=gen, device=dev) * 0.1
    v_rows = torch.rand((T, PK, D), generator=gen, device=dev) - 0.5
    centers3 = torch.randint(0, 70_000, (T, G), generator=gen, device=dev)
    negs = torch.randint(0, 70_000, (T, PK), generator=gen, device=dev)
    negs[:, :4] = centers3[:, :4]
    af3 = (torch.rand((T, G), generator=gen, device=dev) < 0.95).float()
    alpha = torch.full((1, 1), 0.05, device=dev)
    want = quantized_scores_plain(cavg3, v_rows, centers3, negs, af3, alpha,
                                  1, 0.0, P)
    f = torch.bmm(cavg3, quantize(v_rows, 1).transpose(1, 2))
    x = (f + 6.0) * 83.0
    edge = (((x - x.round()).abs() < 83.0 * 2e-5) & (f.abs() <= 6.0)) | (
        (f.abs() - 6.0).abs() < 2e-5)
    keep = (~edge.any(dim=2), ~edge.any(dim=1))
    stream = torch.cuda.current_stream(dev).cuda_stream
    for (n, u, stop), lib in libs.items():
        lib.w2b_scores.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                                   + [ctypes.c_float, ctypes.c_void_p])
        lib.w2b_scores.restype = ctypes.c_int
        for cl in SCORE_CLUSTERS:
            bufs = [(torch.empty((T, G, D), device=dev),
                     torch.empty((T, PK, D), device=dev),
                     torch.empty((T,), device=dev)) for _ in range(2)]

            def call(b):
                err = lib.w2b_scores(
                    cavg3.data_ptr(), v_rows.data_ptr(), centers3.data_ptr(),
                    negs.data_ptr(), af3.data_ptr(), alpha.data_ptr(),
                    b[0].data_ptr(), b[1].data_ptr(), b[2].data_ptr(), T, G,
                    PK, D, P, 1, cl, 0.0, stream)
                if err:
                    raise RuntimeError(f"w2b_scores threads {n} unroll {u} "
                                       f"cluster {cl}: cudaError_t {err}")
            if stop:
                ms = time_ms(lambda: call(bufs[0]))
                print(f"[tune score] threads {n}, unroll {u}, cluster {cl}, "
                      f"stopped after phase {stop}: {ms:.5f} ms")
                continue
            call(bufs[0])
            call(bufs[1])
            torch.cuda.synchronize()
            ok = all(torch.equal(a, b) for a, b in zip(*bufs))
            err = max(float((g[k] - w[k]).abs().max()) for g, w, k in
                      zip(bufs[0][:2], want[:2], keep))
            close = all(torch.allclose(g[k], w[k], atol=1e-5, rtol=1e-4)
                        for g, w, k in zip(bufs[0][:2], want[:2], keep))
            ms = time_ms(lambda: call(bufs[0]))
            print(f"[tune score] threads {n}, unroll {u}, cluster {cl}: "
                  f"{ms:.5f} ms, max "
                  f"abs err {err:.3e} (within tolerance: {close}), two "
                  f"launches bit-equal: {ok}")


def _step_ids(rng, V: int, n_slab: int, n_neg: int, n_sentinel: int):
    from word2bits_tpu_torch.kernels.span_scatter import SENTINEL
    p = np.arange(1, V + 1, dtype=np.float64) ** -1.05
    p /= p.sum()
    p_kept = p * np.minimum((np.sqrt(p / 1e-3) + 1.0) * 1e-3 / p, 1.0)
    p_neg = p ** 0.75
    ids = np.concatenate([rng.choice(V, n_slab, p=p_kept / p_kept.sum()),
                          rng.choice(V, n_neg, p=p_neg / p_neg.sum())])
    ids[rng.choice(ids.size, n_sentinel, replace=False)] = SENTINEL
    return ids.astype(np.int64)


def tune_grmw(dev) -> None:
    from word2bits_tpu_torch.kernels.span_scatter import sort_plan, workspace
    libs = _build("group_rmw", _variant_defines("GRMW", GRMW_VARIANTS))
    V, C, B, W = 3_699_941, 1600, 16384, 8
    n_slab = B + 2 * W
    N = n_slab + (B // 64) * 24
    rng = np.random.default_rng(SEED + 7)
    ids = torch.from_numpy(_step_ids(rng, V, n_slab, N - n_slab, 64)).to(dev)
    rows = torch.randn((N, C), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 0.01
    table = torch.empty((V, C), dtype=torch.bfloat16, device=dev)
    table.uniform_(-0.5, 0.5, generator=torch.Generator(
        device=dev).manual_seed(SEED + 1))
    plan = sort_plan(ids)
    keep = ids < V
    touched, slot = torch.unique(ids[keep], return_inverse=True)
    before = table[touched].clone()
    acc = torch.zeros((touched.numel(), C), device=dev)
    acc.index_add_(0, slot, rows[keep].to(torch.bfloat16).float())
    want = (before.float() + acc).to(torch.bfloat16).float()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for v, lib in libs.items():
        fn = lib.w2b_group_rmw
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for f in (lib.w2b_group_rmw_partials, lib.w2b_group_rmw_counters):
            f.argtypes = [ctypes.c_int, ctypes.c_int]
            f.restype = ctypes.c_longlong
        part, count = workspace(dev, lib.w2b_group_rmw_partials(N, C),
                                lib.w2b_group_rmw_counters(N, C))

        def call():
            err = fn(table.data_ptr(), rows.data_ptr(), plan.sids.data_ptr(),
                     plan.order.data_ptr(), part.data_ptr(),
                     count.data_ptr(), N, V, C, 1, 0, stream)
            if err:
                raise RuntimeError(f"w2b_group_rmw {v}: cudaError_t {err}")
        got = []
        for _ in range(2):
            table[touched] = before
            call()
            got.append(table[touched].clone())
        torch.cuda.synchronize()
        ok = torch.equal(got[0], got[1])
        err = float((got[0].float() - want).abs().max())
        close = torch.allclose(got[0].float(), want, atol=1e-5, rtol=2 ** -7)
        ms = time_ms(call)
        table[touched] = before
        print(f"[tune grmw] {dict(zip(GRMW_NAMES, v))}: {ms:.5f} ms, max abs "
              f"err {err:.3e} (within tolerance: {close}), two launches "
              f"bit-equal: {ok}")
    del table
    torch.cuda.empty_cache()


def _tile_lib(lib, entry: str):
    """The C entry point of a tiled scatter and its workspace sizes."""
    fn = getattr(lib, entry)
    n_ptr = 8 if entry == "w2b_hot_slice" else 6
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    sizes = []
    for suffix in ("partials", "counters"):
        f = getattr(lib, f"{entry}_{suffix}")
        f.argtypes = [ctypes.c_int, ctypes.c_int]
        f.restype = ctypes.c_longlong
        sizes.append(f)
    return fn, sizes


def _variant_defines(prefix: str, variants):
    return [(v, tuple(f"W2B_{prefix}_{k}={x}"
                      for k, x in zip(GRMW_NAMES, v))) for v in variants]


def tune_hot(dev) -> None:
    from word2bits_tpu_torch.kernels.hot_pallas import (hot_plan,
                                                        hot_slice_add_plain)
    from word2bits_tpu_torch.kernels.span_scatter import workspace
    libs = _build("hot_slice", _variant_defines("HOT", HOT_VARIANTS) + [
        (("stop", k), (f"W2B_TILE_STOP={k}",)) for k in TILE_STOPS])
    V, C, H, N = 70_000, 400, 2048, 8192 + 16
    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    table0 = (torch.rand((V, C), generator=gen, device=dev) - 0.5).to(
        torch.bfloat16)
    ids = torch.from_numpy(_step_ids(rng, V, N, 0, 0)).to(dev)
    rows = torch.randn((N, C), generator=gen, device=dev) * 0.01
    ext = torch.randn((H, C), generator=gen, device=dev) * 0.01
    plan = hot_plan(ids, H)
    want = {e: hot_slice_add_plain(table0.clone(), ids, rows, H, x)[:H]
            for e, x in (("no extra", None), ("extra", ext))}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for v, lib in libs.items():
        fn, (n_part, n_count) = _tile_lib(lib, "w2b_hot_slice")
        part, count = workspace(dev, n_part(N, C), n_count(N, C))
        stop = v[1] if v[0] == "stop" else 0
        line = []
        for e, x in (("no extra", None), ("extra", ext)):
            table = table0[:H].clone()

            def call():
                err = fn(table.data_ptr(), rows.data_ptr(),
                         None if x is None else x.data_ptr(),
                         plan.sids.data_ptr(), plan.order.data_ptr(),
                         plan.starts.data_ptr(), part.data_ptr(),
                         count.data_ptr(), N, H, C, 1, 0, stream)
                if err:
                    raise RuntimeError(f"w2b_hot_slice {v}: cudaError_t "
                                       f"{err}")
            if stop:
                line.append(f"{e} {time_ms(call):.5f} ms")
                continue
            got = []
            for _ in range(2):
                table.copy_(table0[:H])
                call()
                got.append(table.clone())
            torch.cuda.synchronize()
            ok = torch.equal(got[0], got[1])
            err = float((got[0].float() - want[e].float()).abs().max())
            close = torch.allclose(got[0].float(), want[e].float(),
                                   atol=1e-5, rtol=2 ** -7)
            ms = time_ms(call)
            line.append(f"{e} {ms:.5f} ms (max abs err {err:.3e}, within "
                        f"tolerance: {close}, two launches bit-equal: {ok})")
        what = (f"kept constants, stopped after phase {stop}" if stop
                else dict(zip(GRMW_NAMES, v)))
        print(f"[tune hot] {what}: " + "; ".join(line))


def tune_rmw(dev) -> None:
    from word2bits_tpu_torch.kernels.scatter_pallas import \
        scatter_add_rmw_plain
    from word2bits_tpu_torch.kernels.span_scatter import (SENTINEL, sort_plan,
                                                          workspace)
    libs = _build("group_rmw", _variant_defines("RMW", RMW_VARIANTS))
    V, C, B, W = 3_699_941, 1600, 16384, 8
    n_slab, n_neg = B + 2 * W, (B // 64) * 24
    rng = np.random.default_rng(SEED + 8)
    both = _step_ids(rng, V, n_slab, n_neg, 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    calls = []
    for ids in (both[:n_slab].copy(), both[n_slab:].copy()):
        ids[rng.choice(ids.size, 64, replace=False)] = SENTINEL
        ids = torch.from_numpy(ids).to(dev)
        rows = torch.randn((ids.numel(), C), generator=gen, device=dev) * 0.01
        calls.append((ids, rows, sort_plan(ids)))
    table = torch.empty((V, C), dtype=torch.bfloat16, device=dev)
    table.uniform_(-0.5, 0.5, generator=torch.Generator(
        device=dev).manual_seed(SEED + 9))
    all_ids = torch.cat([c[0] for c in calls])
    touched = torch.unique(all_ids[all_ids < V])
    before = table[touched].clone()
    # the plain version on the touched rows alone, ids as their slots
    want = before.clone()
    mags = torch.zeros((touched.numel(), C), device=dev)
    for ids, rows, _ in calls:
        slot = torch.where(ids < V, torch.searchsorted(touched, ids),
                           touched.numel())
        scatter_add_rmw_plain(want, slot, rows)
        keep = ids < V
        mags.index_add_(0, slot[keep], rows[keep].abs())
    allowed = 2 ** -6 * (want.float().abs() + mags) + 1e-6
    stream = torch.cuda.current_stream(dev).cuda_stream
    for v, lib in libs.items():
        fn, (n_part, n_count) = _tile_lib(lib, "w2b_scatter_rmw")
        N = max(c[0].numel() for c in calls)
        part, count = workspace(dev, n_part(N, C), n_count(N, C))

        def call():
            for ids, rows, plan in calls:
                err = fn(table.data_ptr(), rows.data_ptr(),
                         plan.sids.data_ptr(), plan.order.data_ptr(),
                         part.data_ptr(), count.data_ptr(),
                         ids.numel(), V, C, 1, 0, stream)
                if err:
                    raise RuntimeError(f"w2b_scatter_rmw {v}: cudaError_t "
                                       f"{err}")
        got = []
        for _ in range(2):
            table[touched] = before
            call()
            got.append(table[touched].clone())
        torch.cuda.synchronize()
        ok = torch.equal(got[0], got[1])
        diff = (got[0].float() - want.float()).abs()
        close = bool((diff <= allowed).all())
        ms = time_ms(call)
        table[touched] = before
        print(f"[tune rmw] {dict(zip(GRMW_NAMES, v))}: {ms:.5f} ms for the "
              f"two calls, max abs err {float(diff.max()):.3e} (within "
              f"tolerance: {close}), two launches bit-equal: {ok}")
    del table
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("score", "grmw", "hot", "rmw",
                                         "all"), default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.kernel in ("score", "all"):
        tune_score(dev)
    if args.kernel in ("grmw", "all"):
        tune_grmw(dev)
    if args.kernel in ("hot", "all"):
        tune_hot(dev)
    if args.kernel in ("rmw", "all"):
        tune_rmw(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
