"""The mesh on real process groups: gloo on the CPU, spawned processes.

* DistCollectives on a 2-rank group is bit-equal to LocalMesh on the same
  chunks (a data axis of 2 with kernel 2's span route, then a vocab axis
  of 2 with kernel 8's rmw route and the dense route), and the two ranks
  draw the same shrinks and negatives from their equally seeded
  generators.
* `cli train -mesh-shape data=2,vocab=2` on a 4-rank group, as torchrun
  starts it (its environment, W2B_FORCE_CPU=1), writes the vector file,
  which reads back as +-1/3.

Each group binds a free port on 127.0.0.1 and is destroyed by its ranks.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.parallel.chunk import make_sharded_chunk
from word2bits_tpu_torch.parallel.mesh import (DATA_AXIS, DistCollectives,
                                               LocalMesh, make_mesh)
from word2bits_tpu_torch.parallel.multihost import free_port
from word2bits_tpu_torch.parallel.sharded import pad_vocab_rows, shard_params
from word2bits_tpu_torch.parallel.sharded_slab import _sharded_slab_body
from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                  draw_negatives)

S, B, W, K, V, D, G = 3, 32, 3, 4, 45, 16, 8
SEED = 3
# (mesh, chunk keywords, steps)
CHUNKS = [({"data": 2}, dict(neg_sharing=G, neg_pool=2, banded=8,
                             scatter_impl="span"), S),
          ({"vocab": 2}, dict(neg_sharing=G, rmw=True), 1),
          ({"vocab": 2}, dict(neg_sharing=0), S)]


def _inputs():
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-0.5, 0.5, (V, D)).astype(np.float32))
    n = W + S * B + W
    toks = rng.integers(1, V, n)
    sents = np.sort(rng.integers(0, 6, n))
    toks[:2] = -1
    sents[:2] = -1
    atab = build_alias_table(rng.integers(1, 50, V) ** 0.75)
    scalars = ChunkScalars(base0=W, alpha0=0.05, wca_start=0.0,
                           wca_per_step=250.0, denom=1e5)
    return u, v, torch.from_numpy(toks), torch.from_numpy(sents), atab, \
        scalars


def _run_chunk(comm, mesh_shape, kw, steps):
    u, v, toks, sents, atab, scalars = _inputs()
    nv = comm.nv
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K, reg=0.01)
    up, vp = pad_vocab_rows(u, nv), pad_vocab_rows(v, nv)
    chunk = make_sharded_chunk(_sharded_slab_body, hyper, comm, up.shape[0],
                               V, B, steps, **kw)
    gen = torch.Generator().manual_seed(SEED)
    ul, vl, loss = chunk(comm, *shard_params(up, vp, comm), toks, sents, atab,
                         scalars, gen)
    return ul, vl, loss, gen.get_state()


def _pair_worker(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        results = []
        for mesh_shape, kw, steps in CHUNKS:
            comm = DistCollectives(make_mesh(mesh_shape))
            results.append(_run_chunk(comm, mesh_shape, kw, steps))
        # the draws of a freshly seeded generator, from both ranks
        _, _, _, _, atab, _ = _inputs()
        gen = torch.Generator().manual_seed(SEED)
        draws = torch.cat([
            torch.randint(0, W, (S, B), generator=gen).reshape(-1),
            draw_negatives(gen, atab, (S, B // G, 2 * K), V).reshape(-1)])
        comm = DistCollectives(make_mesh({"data": 2}))
        both = comm.all_gather(draws[None], DATA_AXIS)
        torch.save({"chunks": results, "draws": both},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_dist_collectives_bit_equal_local_mesh(tmp_path):
    mp.start_processes(_pair_worker, args=(free_port(), str(tmp_path)),
                       nprocs=2, start_method="spawn")
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    d = got[0]["draws"]
    assert torch.equal(d[0], d[1])            # the ranks drew alike
    for ci, (mesh_shape, kw, steps) in enumerate(CHUNKS):
        want = LocalMesh.of(mesh_shape).run(
            lambda comm: _run_chunk(comm, mesh_shape, kw, steps))
        for r in range(2):
            ul, vl, loss, state = got[r]["chunks"][ci]
            wl, wv, wloss, wstate = want[r]
            assert torch.equal(ul, wl) and torch.equal(vl, wv), (ci, r)
            assert torch.equal(loss, wloss), (ci, r)
            assert torch.equal(state, wstate)        # the same draws used
            assert torch.equal(state, got[1 - r]["chunks"][ci][3])


def _cli_worker(rank, port, corpus, out):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="4", RANK=str(rank), LOCAL_RANK=str(rank),
                      W2B_FORCE_CPU="1")
    from word2bits_tpu_torch import cli
    rc = cli.train_main([
        "-train", corpus, "-output", out, "-binary", "1", "-size", "16",
        "-window", "3", "-negative", "5", "-iter", "2", "-min-count", "1",
        "-bitlevel", "1", "-batch-size", "64", "-steps-per-chunk", "2",
        "-neg-sharing", "16", "-neg-pool", "2", "-banded-tile", "16",
        "-scatter-impl", "span", "-mesh-shape", "data=2,vocab=2",
        "-debug", "0"])
    assert rc == 0 and not dist.is_initialized()


def test_cli_train_on_a_four_rank_mesh(tmp_path):
    from word2bits_tpu_torch.io.vectors import read_vectors
    rng = np.random.default_rng(11)
    words = [f"w{i}" for i in range(60)]
    corpus = tmp_path / "c.txt"
    corpus.write_text("\n".join(
        " ".join(words[rng.integers(60)] for _ in range(10))
        for _ in range(400)) + "\n")
    out = tmp_path / "vec.bin"
    mp.start_processes(_cli_worker,
                       args=(free_port(), str(corpus), str(out)),
                       nprocs=4, start_method="spawn")
    ws, vecs = read_vectors(str(out))
    assert len(ws) == 61                      # </s> + 60 words
    np.testing.assert_allclose(np.unique(np.abs(vecs)), 1.0 / 3, rtol=1e-6)
