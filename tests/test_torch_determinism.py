"""Same seed, same vectors: the port's counterpart of tests/test_determinism.py
on every update route, and the plain scatter-add the `add` routes share.

- Each route of chip_smoke.py's [determinism] (b), at narrow widths through
  train.train on the CPU (the 2 x 2 mesh through a LocalMesh chunk with
  draws from a seeded generator): the same seed gives bit-equal tables and
  equal epoch losses, another seed other tables.
- ops/scatter.scatter_add against the JAX package's plain scatter,
  `table.at[ids].add(rows.astype(dtype), mode="drop")`, at float32 and
  bfloat16 with duplicates, the drop SENTINEL and ids >= V (tolerances of
  tests/test_scatter.py); negative ids are dropped, as XLA's scatter and
  kernel 2 drop them (jnp's `.at[]` would first wrap -1 to V - 1; no call
  site passes a negative id to a scatter).
- The guard: one CPU step of each route under utils/audit.ScatterAudit.
  Every accumulating scatter it reaches must come from scatter_add's CPU
  branch or a kernel's plain version (`*_plain`), the places that do not
  run on the card, so a new `index_add_` on the training path fails here.
"""

import contextlib
import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu_torch import config as tconfig
from word2bits_tpu_torch import train as ttrain
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.ops.scatter import SENTINEL, scatter_add
from word2bits_tpu_torch.parallel.chunk import make_sharded_chunk
from word2bits_tpu_torch.parallel.mesh import LocalMesh
from word2bits_tpu_torch.parallel.sharded_skipgram import \
    _sharded_skipgram_body
from word2bits_tpu_torch.parallel.sharded_slab import _sharded_slab_body
from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                  draw_negatives)
from word2bits_tpu_torch.utils.audit import ScatterAudit, allowed

BASE = ["-size", "16", "-window", "3", "-negative", "5", "-min-count", "2",
        "-bitlevel", "1", "-binary", "1", "-batch-size", "64",
        "-steps-per-chunk", "4", "-debug", "0"]
FUSED_ADD = ["-fused-tables", "1", "-neg-sharing", "8", "-neg-pool", "2",
             "-banded-tile", "16", "-scatter-impl", "add"]
# [determinism] (b)'s routes: the Quick start, the score kernel, the
# hot/cold split without kernel 6, its stratified and dense-hot strata,
# skip-gram, the block dedup on both engines
ADD_ROUTES = {
    "quickstart": [],
    "pallas, fused bf16": FUSED_ADD + ["-use-pallas", "1", "-dtype",
                                       "bfloat16", "-context-pallas", "1"],
    "pallas, split": ["-neg-sharing", "8", "-neg-pool", "2", "-use-pallas",
                      "1"],
    "hot-rows": FUSED_ADD + ["-hot-rows", "6", "-dtype", "bfloat16"],
    "neg-stratify": FUSED_ADD + ["-hot-rows", "6", "-neg-stratify", "1"],
    "neg-dense-hot": FUSED_ADD + ["-hot-rows", "6", "-neg-dense-hot", "1"],
    "skipgram": ["-model", "skipgram"],
    "skipgram, dense-hot": ["-model", "skipgram", "-hot-rows", "6",
                            "-neg-dense-hot", "1"],
    "dedup-block, fused": FUSED_ADD + ["-dedup-block", "64"],
    "dedup-block, slab": ["-dedup-block", "64"],
}
# the routes whose scatter is one of the port's own kernels
KERNEL_ROUTES = {
    "span": FUSED_ADD[:-1] + ["span", "-context-pallas", "1"],
    "grmw": FUSED_ADD[:-1] + ["grmw", "-loop-mode", "fori"],
    "hot-rows, hot-pallas": FUSED_ADD + ["-hot-rows", "6", "-hot-pallas",
                                         "1"],
    "rmw-scatter": FUSED_ADD + ["-rmw-scatter", "1", "-steps-per-chunk",
                                "1"],
    "exact": ["-banded-tile", "16", "-scatter-impl", "span",
              "-context-pallas", "1"],
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these steps are many tiny ops, which several
    test workers' thread pools on one machine slow a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(path: Path, n_lines: int = 600) -> Path:
    """A small topic corpus (.claude/skills/verify/SKILL.md, surface 1)."""
    rng = np.random.default_rng(42)
    topics = [["cat", "dog", "pet", "fur", "paw", "tail"],
              ["sun", "moon", "star", "sky", "cloud", "rain"],
              ["red", "blue", "green", "color", "paint", "ink"],
              ["run", "walk", "jump", "move", "step", "go"]]
    fill = ["the", "a", "of", "and", "to", "in"]
    lines = [" ".join([fill[rng.integers(6)] if rng.random() < .3
                       else t[rng.integers(6)]
                       for _ in range(rng.integers(8, 16))])
             for t in (topics[rng.integers(4)] for _ in range(n_lines))]
    path.write_text("\n".join(lines) + "\n")
    return path


def _train(corpus: Path, argv: list, seed: int, **kw):
    cfg = tconfig.config_from_argv(BASE + argv + [
        "-train", str(corpus), "-iter", "2", "-seed", str(seed)])
    with contextlib.redirect_stdout(io.StringIO()):
        return ttrain.train(cfg, device="cpu", **kw)


@pytest.mark.parametrize("route", list(ADD_ROUTES))
def test_same_seed_same_tables(tmp_path, route):
    """tests/test_determinism.py on the port: two runs at -seed 11 give
    bit-equal tables and equal epoch losses, a run at -seed 12 other
    tables."""
    corpus = _corpus(tmp_path / "c.txt")
    r1, r2, r3 = (_train(corpus, ADD_ROUTES[route], seed)
                  for seed in (11, 11, 12))
    assert len(r1.tables) == len(r2.tables)
    for a, b in zip(r1.tables, r2.tables):
        assert torch.equal(a, b)
    assert r1.epoch_losses == r2.epoch_losses
    assert len(r1.epoch_losses) == 2
    assert not all(torch.equal(a, c) for a, c in zip(r1.tables, r3.tables))


def _mesh_run(body, kw: dict, seed: int, audit: bool = False):
    """Four steps of the sharded chunk on a 2 x 2 LocalMesh (the `add`
    route), split float32 tables, draws from a generator seeded `seed`:
    (u, v, loss, every shard's audit calls)."""
    rng = np.random.default_rng(0)
    V, D, B, W, K, G, P, S = 40, 8, 32, 2, 3, 8, 2, 4
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    n = S * B + 2 * W + 8
    tokens = torch.from_numpy(rng.integers(0, V, n))
    tokens[:W] = -1
    sents = torch.arange(n) // 11
    sents[:W] = -1
    atab = build_alias_table(np.arange(V, 0, -1.0) ** 0.75)
    gen = torch.Generator().manual_seed(seed)
    shrinks = torch.randint(0, W, (S, B), generator=gen)
    negs = draw_negatives(gen, atab, (S, B // G, P * K), V)
    u0 = torch.rand((V, D), generator=gen) - 0.5
    v0 = torch.rand((V, D), generator=gen) - 0.5
    sc = ChunkScalars(base0=W, alpha0=0.05, wca_start=0.0,
                      wca_per_step=float(B), denom=1e4)
    chunk = make_sharded_chunk(body, hyper, LocalMesh(2, 2), V, V, B, S,
                               neg_sharing=G, neg_pool=P, **kw)
    calls = []

    def shard(comm):
        vi = comm.rank % 2
        ul = u0[vi * V // 2:(vi + 1) * V // 2].clone()
        vl = v0[vi * V // 2:(vi + 1) * V // 2].clone()
        with (ScatterAudit() if audit else contextlib.nullcontext()) as a:
            out = chunk(comm, ul, vl, tokens, sents, atab, sc,
                        shrinks=shrinks, negs=negs)
        if audit:
            calls.extend(a.calls)
        return out

    res = LocalMesh(2, 2).run(shard)
    u = torch.cat([res[0][0], res[1][0]])
    v = torch.cat([res[0][1], res[1][1]])
    return u, v, float(res[0][2]), calls


MESH_BODIES = {"slab": (_sharded_slab_body, dict(banded=8)),
               "skipgram": (_sharded_skipgram_body, {})}


@pytest.mark.parametrize("body", list(MESH_BODIES))
def test_mesh_add_route_same_seed_same_tables(body):
    fn, kw = MESH_BODIES[body]
    (u1, v1, l1, _), (u2, v2, l2, _), (u3, v3, _, _) = (
        _mesh_run(fn, kw, seed) for seed in (5, 5, 6))
    assert torch.equal(u1, u2) and torch.equal(v1, v2) and l1 == l2
    assert not (torch.equal(u1, u3) and torch.equal(v1, v3))


def _scatter_case(rng, V: int, C: int, N: int):
    ids = rng.integers(0, V, N)                   # N > V: duplicates
    ids[rng.choice(N, N // 10, replace=False)] = SENTINEL
    ids[rng.choice(N, N // 10, replace=False)] = V + rng.integers(0, 9,
                                                                  N // 10)
    ids[:3] = 7                                   # one id thrice in a row
    rows = rng.normal(size=(N, C)).astype(np.float32)
    table = rng.normal(size=(V, C)).astype(np.float32)
    return ids, rows, table


# tests/test_scatter.py's tolerances: float32 against the baseline, bf16
# within the baseline's own rounding envelope
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=0.02, atol=0.05)}


@pytest.mark.parametrize("dtype", list(TOL))
def test_scatter_add_matches_xla(dtype):
    rng = np.random.default_rng(3)
    V, C, N = 97, 24, 600
    ids, rows, table = _scatter_case(rng, V, C, N)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jnp.asarray(table, jdt).at[jnp.asarray(ids)].add(
        jnp.asarray(rows).astype(jdt), mode="drop")
    got = scatter_add(torch.tensor(table).to(tdt), torch.from_numpy(ids),
                      torch.from_numpy(rows))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL))
def test_scatter_add_drops_negative_ids(dtype):
    """-1 padding drops: the same table as the scatter of the other ids,
    bit for bit; index 0 and V - 1 receive nothing from it."""
    rng = np.random.default_rng(4)
    V, C, N = 50, 8, 200
    ids, rows, table = _scatter_case(rng, V, C, N)
    neg = rng.choice(N, 40, replace=False)
    ids[neg] = -1
    ids[neg[:5]] = -V                             # jnp would wrap these too
    tdt = getattr(torch, dtype)
    keep = ids >= 0
    got = scatter_add(torch.tensor(table).to(tdt), torch.from_numpy(ids),
                      torch.from_numpy(rows))
    want = scatter_add(torch.tensor(table).to(tdt),
                       torch.from_numpy(ids[keep]),
                       torch.from_numpy(rows[keep]))
    assert torch.equal(got, want)
    jdt = getattr(jnp, dtype)
    ref = jnp.asarray(table, jdt).at[jnp.asarray(ids[keep])].add(
        jnp.asarray(rows[keep]).astype(jdt), mode="drop")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


def test_scatter_add_empty_and_out_of_range_only():
    table = torch.rand(10, 4)
    before = table.clone()
    scatter_add(table, torch.zeros(0, dtype=torch.long), torch.zeros(0, 4))
    scatter_add(table, torch.tensor([10, SENTINEL, -1]), torch.ones(3, 4))
    assert torch.equal(table, before)


def test_scatter_add_raises_off_cpu_and_cuda():
    meta = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        scatter_add(meta, torch.zeros(2, dtype=torch.long, device="meta"),
                    torch.zeros(2, 2, device="meta"))


def test_audit_flags_stray_accumulating_scatters():
    """The guard sees an accumulating scatter called from anywhere else,
    and only accumulating ones."""
    t = torch.zeros(4, 2)
    idx = torch.tensor([1, 1])
    with ScatterAudit() as audit:
        t.index_add_(0, idx, torch.ones(2, 2))
        t.index_put_((idx,), torch.ones(2, 2), accumulate=True)
        t.put_(idx, torch.ones(2), True)
        t.scatter_add_(0, idx[:, None].expand(2, 2), torch.ones(2, 2))
        t.index_put_((idx,), torch.ones(2, 2))     # not accumulating
        t[idx] = 1.0
        scatter_add(t, idx, torch.ones(2, 2))
    ops = [c.op for c in audit.calls]
    assert ops == ["index_add_", "index_put_", "put_", "scatter_add_",
                   "index_add_"]
    assert [allowed(c) for c in audit.calls] == [False] * 4 + [True]
    assert audit.calls[0].caller.endswith(
        "test_torch_determinism:test_audit_flags_stray_accumulating_scatters")


@pytest.mark.parametrize("route", list(ADD_ROUTES) + list(KERNEL_ROUTES))
def test_training_path_scatters_only_through_scatter_add(tmp_path, route):
    """One step of each route through train.train under the audit: every
    accumulating scatter comes from scatter_add's CPU branch or a kernel's
    plain version."""
    corpus = _corpus(tmp_path / "c.txt", n_lines=100)
    argv = {**ADD_ROUTES, **KERNEL_ROUTES}[route]
    if "-steps-per-chunk" not in argv:
        argv = argv + ["-steps-per-chunk", "1"]
    with ScatterAudit() as audit:
        _train(corpus, argv, 1, max_steps=1)
    assert audit.calls, "no scatter reached: the audit saw nothing"
    assert not audit.not_allowed(), audit.not_allowed()


@pytest.mark.parametrize("body", list(MESH_BODIES))
def test_mesh_scatters_only_through_scatter_add(body):
    fn, kw = MESH_BODIES[body]
    *_, calls = _mesh_run(fn, kw, 5, audit=True)
    assert calls and all(allowed(c) for c in calls), calls
