"""How far two bitlevel-1 training runs that differ only in summation
order drift apart, step by step.

    python3 -m word2bits_tpu_torch.tools.mesh_divergence
        [--meshes 2x1,1x4] [--dtype float32|bfloat16] [--steps 256]
        [--marks 1,8,16,32,48,64,128,256] [--tokens N]

On a synthetic text8-like corpus (written inside the checkout, removed
afterwards) at the shipped widths on split tables (B = 8192, D = 200,
window 8, 24 negatives, 64-center tiles with 2 pools, banded 256, the
span scatter), one set of draws goes through
  * the single-device slab chunk with the `span` scatter (the reference),
  * the same chunk with the `add` scatter (ops/scatter.scatter_add: the
    same updates, each id's rows summed in float32 in the sorted order and
    added once per step, where the span chunk's plan covers the chunk), and
  * each LocalMesh of --meshes (parallel/mesh.py: every shard in this
    process), run in lockstep with the reference.
At each mark it prints, against the reference, the largest difference,
the relative Frobenius difference of u and v, and the number of table
entries whose sign differs.  Bitlevel 1 quantizes an entry by its sign,
so a first differing sign starts a cascade (PERF.md section 6).
Runs on the card; `--device cpu` runs the plain versions.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
B, S_MAX, W, D, K, G, P, TILE = 8192, 256, 8, 200, 24, 64, 2, 256


def _corpus(tokens: int):
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.data.synthetic import zipf_corpus
    from word2bits_tpu_torch.train import prepare
    work = os.path.join(REPO, ".smoke_work", "divergence")
    os.makedirs(work, exist_ok=True)
    try:
        path = os.path.join(work, "corpus.txt")
        zipf_corpus(path, n_tokens=tokens, vocab=70_000, seed=0)
        return prepare(config_from_argv(["-train", path, "-debug", "0"]))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _diff(a: torch.Tensor, b: torch.Tensor) -> tuple:
    d = a.float() - b.float()
    return (float(d.abs().max()), float(d.norm() / b.float().norm()),
            int(((a > 0) != (b > 0)).sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--meshes", default="2x1,1x4")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--steps", type=int, default=S_MAX)
    ap.add_argument("--marks", default="1,8,16,32,40,44,48,56,64,128,256")
    ap.add_argument("--tokens", type=int, default=17_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("mesh_divergence: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60, check=True)
        print(f"card: {card.stdout.strip()}")
        from word2bits_tpu_torch.kernels._build import build_all
        build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    from word2bits_tpu_torch.data.pipeline import build_epoch_arrays
    from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
    from word2bits_tpu_torch.models.cbow_slab import make_slab_train_chunk
    from word2bits_tpu_torch.models.init import init_params
    from word2bits_tpu_torch.parallel.chunk import make_sharded_chunk
    from word2bits_tpu_torch.parallel.mesh import LocalMesh
    from word2bits_tpu_torch.parallel.sharded_slab import _sharded_slab_body
    from word2bits_tpu_torch.sampling.unigram import (build_alias_table,
                                                      draw_negatives)

    vocab, encoded = _corpus(args.tokens)
    V, S = vocab.size, args.steps
    cap = ((len(encoded) + S * B + 8 + 1023) // 1024) * 1024
    ep = build_epoch_arrays(encoded, vocab.counts, 1e-3, vocab.train_words,
                            W, np.random.default_rng(0), capacity=cap)
    tokens = torch.from_numpy(ep.tokens).to(dev, torch.int64)
    sents = torch.from_numpy(ep.sent_ids).to(dev, torch.int64)
    atab = build_alias_table(vocab.unigram_weights()).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    shrinks = torch.randint(0, W, (S, B), generator=gen, device=dev)
    negs = draw_negatives(gen, atab, (S, B // G, P * K), V)
    hyper = CBOWHyper(bitlevel=1, size=D, window=W, negative=K)
    kw = dict(neg_sharing=G, neg_pool=P, banded=TILE, scatter_impl="span")
    dtype = getattr(torch, args.dtype)

    def scalars(first: int) -> ChunkScalars:
        return ChunkScalars(base0=W + first * B, alpha0=0.1,
                            wca_start=first * float(B), wca_per_step=float(B),
                            denom=float(vocab.train_words) + 1.0)

    span = make_slab_train_chunk(hyper, V, B, S, **kw)
    add = make_slab_train_chunk(hyper, V, B, S, **dict(kw, scatter_impl="add"))
    ref = init_params(V, D, dtype=dtype, device=dev)
    ctl = init_params(V, D, dtype=dtype, device=dev)
    meshes = []
    for spec in args.meshes.split(","):
        nd, nv = (int(x) for x in spec.split("x"))
        Vs = -(-V // nv)
        u0, v0 = init_params(V, D, dtype=dtype, device=dev)
        shards = []
        for r in range(nd * nv):
            vi = r % nv
            pair = []
            for t in (u0, v0):
                x = torch.zeros((Vs, D), dtype=dtype, device=dev)
                rows = t[vi * Vs:(vi + 1) * Vs]
                x[:rows.shape[0]] = rows
                pair.append(x)
            shards.append(pair)
        chunk = make_sharded_chunk(_sharded_slab_body, hyper,
                                   LocalMesh(nd, nv), Vs * nv, V, B, S, **kw)
        meshes.append((spec, LocalMesh(nd, nv, dev), shards, chunk))
    print(f"V={V}, B={B}, {args.dtype} tables; against the span chunk: max "
          "|d| / rel |d|_F / entries of another sign, for u and v")
    done = 0
    for mark in sorted(int(m) for m in args.marks.split(",")):
        if mark > S:
            break
        sl = slice(done, mark)
        inj = dict(n_steps=mark - done, shrinks=shrinks[sl], negs=negs[sl])
        span(*ref, tokens, sents, atab, scalars(done), **inj)
        add(*ctl, tokens, sents, atab, scalars(done), **inj)
        parts = [f"add {_diff(ctl[0], ref[0])} {_diff(ctl[1], ref[1])}"]
        for spec, lm, shards, chunk in meshes:
            def step(comm, shards=shards, chunk=chunk):
                ul, vl = shards[comm.rank]
                chunk(comm, ul, vl, tokens, sents, atab, scalars(done),
                      **inj)

            lm.run(step)
            nv = int(spec.split("x")[1])
            got = [torch.cat([shards[vi][i] for vi in range(nv)])[:V]
                   for i in (0, 1)]
            parts.append(f"{spec} {_diff(got[0], ref[0])} "
                         f"{_diff(got[1], ref[1])}")
        done = mark
        print(f"step {mark}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
