"""The port's parallel/ integer maps, bootstrap and LocalMesh collectives
(CPU).

`layout` and `multihost` are held bit-equal to the JAX package's on the
cases of tests/test_layout.py and tests/test_multihost.py; LocalMesh's
psum and all_gather against their definitions; a mesh larger than the
processes raises.
"""

import numpy as np
import pytest
import torch

from word2bits_tpu.parallel import layout as jlayout
from word2bits_tpu.parallel import multihost as jmh
from word2bits_tpu_torch.data.corpus import count_words
from word2bits_tpu_torch.parallel import layout as tlayout
from word2bits_tpu_torch.parallel import multihost as tmh
from word2bits_tpu_torch.parallel.mesh import (DATA_AXIS, VOCAB_AXIS,
                                               LocalMesh, make_mesh)

LAYOUT_CASES = [(48, 4, 12), (48, 4, 10), (64, 8, 8), (40, 2, 7), (48, 4, 43)]


@pytest.mark.parametrize("Vp,nv,H", LAYOUT_CASES)
def test_layout_maps_equal_jax(Vp, nv, H):
    import jax.numpy as jnp
    jl = jlayout.make_hot_layout(Vp, nv, H)
    tl = tlayout.make_hot_layout(Vp, nv, H)
    assert tuple(tl) == tuple(jl)
    order = tlayout.layout_order(tl, Vp)
    np.testing.assert_array_equal(order, jlayout.layout_order(jl, Vp))
    assert sorted(order.tolist()) == list(range(Vp))
    ids = np.arange(Vp, dtype=np.int64)
    jo, jloc = jl.owner_local(jnp.asarray(ids, jnp.int32))
    to, tloc = tl.owner_local(torch.from_numpy(ids))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tloc.numpy(), np.asarray(jloc))
    # each shard's ranges are its slots of layout_order, in local order
    Vs = Vp // nv
    for j in range(nv):
        got = np.concatenate([np.arange(a, b) for a, b in tl.ranges(j)])
        np.testing.assert_array_equal(got, order[j * Vs:(j + 1) * Vs])


def test_layout_roundtrip_and_pad_equal_jax():
    jl = jlayout.make_hot_layout(48, 4, 10)
    tl = tlayout.make_hot_layout(48, 4, 10)
    x = np.random.default_rng(0).normal(size=(48, 5)).astype(np.float32)
    np.testing.assert_array_equal(tlayout.to_layout(x, tl),
                                  jlayout.to_layout(x, jl))
    np.testing.assert_array_equal(tlayout.from_layout(tlayout.to_layout(
        x, tl), tl), x)
    xt = torch.from_numpy(x)
    assert torch.equal(tlayout.to_layout(xt, tl),
                       torch.from_numpy(jlayout.to_layout(x, jl)))
    assert torch.equal(tlayout.from_layout(tlayout.to_layout(xt, tl), tl), xt)
    w = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(tlayout.pad_hot_weights(w, tl),
                                  jlayout.pad_hot_weights(w, jl))
    assert torch.equal(tlayout.pad_hot_weights(torch.from_numpy(w), tl),
                       torch.from_numpy(jlayout.pad_hot_weights(w, jl)))


@pytest.mark.parametrize("args", [(48, 4, 0), (48, 4, 48), (50, 4, 8)])
def test_make_hot_layout_rejects_what_jax_rejects(args):
    with pytest.raises(ValueError):
        jlayout.make_hot_layout(*args)
    with pytest.raises(ValueError):
        tlayout.make_hot_layout(*args)


@pytest.mark.parametrize("num_hosts", [1, 2, 3, 5])
def test_sharded_counts_equal_jax_and_full(tmp_path, num_hosts):
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(40)]
    toks = rng.choice(words, 5000)
    p = tmp_path / "c.txt"
    # a word running to EOF unterminated is dropped by both passes
    p.write_bytes((" ".join(toks) + " tail").encode())
    parts = []
    for h in range(num_hosts):
        s, e = tmh.host_byte_range(str(p), h, num_hosts)
        assert (s, e) == jmh.host_byte_range(str(p), h, num_hosts)
        part = tmh.count_words_range(str(p), s, e)
        assert part == jmh.count_words_range(str(p), s, e)
        parts.append(part)
    merged = tmh.merge_counts(parts)
    assert merged == jmh.merge_counts(parts)
    merged.setdefault("</s>", 0)
    assert merged == count_words(str(p), use_native=False)


def test_initialize_without_torchrun_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmh.initialize("cpu") is False
    assert not torch.distributed.is_initialized()


def test_mesh_larger_than_the_world_raises():
    """One process without a group is a world of one device."""
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        make_mesh({"data": 2, "vocab": 2})


def test_cli_mesh_larger_than_the_world_raises(tmp_path, monkeypatch):
    """`cli train -mesh-shape data=2,vocab=2` in a plain process: no group
    of four, so it raises; nothing runs the mesh on one device."""
    from word2bits_tpu_torch import cli
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("W2B_FORCE_CPU", "1")
    corpus = tmp_path / "c.txt"
    corpus.write_text("a b c d a b c d e f\n" * 50)
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        cli.train_main(["-train", str(corpus), "-output",
                        str(tmp_path / "v.bin"), "-size", "8",
                        "-min-count", "1", "-iter", "1", "-batch-size",
                        "16", "-mesh-shape", "data=2,vocab=2", "-debug",
                        "0"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("nd,nv", [(2, 4), (4, 2), (1, 3)])
def test_local_mesh_collectives(nd, nv):
    """psum sums over the axis in rank order (the same bits on every
    shard); all_gather concatenates in rank order; axis coordinates."""
    mesh = LocalMesh(nd, nv)

    def fn(comm):
        x = torch.full((2, 3), 0.1 * (comm.rank + 1), dtype=torch.float32)
        ids = torch.full((2,), comm.rank, dtype=torch.int64)
        return (comm.axis_index(DATA_AXIS), comm.axis_index(VOCAB_AXIS),
                comm.psum(x.clone(), DATA_AXIS),
                comm.psum(x.clone(), VOCAB_AXIS),
                comm.all_gather(ids, DATA_AXIS),
                comm.all_gather(ids, VOCAB_AXIS))

    out = mesh.run(fn)
    for r, (di, vi, pd, pv, gd, gv) in enumerate(out):
        assert (di, vi) == divmod(r, nv)
        dranks = [d * nv + vi for d in range(nd)]
        vranks = [di * nv + v for v in range(nv)]
        want_d = torch.full((2, 3), 0.1 * (dranks[0] + 1))
        for q in dranks[1:]:
            want_d = want_d + torch.full((2, 3), 0.1 * (q + 1))
        want_v = torch.full((2, 3), 0.1 * (vranks[0] + 1))
        for q in vranks[1:]:
            want_v = want_v + torch.full((2, 3), 0.1 * (q + 1))
        assert torch.equal(pd, want_d) and torch.equal(pv, want_v)
        assert gd.tolist() == [q for q in dranks for _ in range(2)]
        assert gv.tolist() == [q for q in vranks for _ in range(2)]


def test_local_mesh_reports_a_shard_error_and_a_mismatch():
    def bad(comm):
        if comm.rank == 1:
            raise KeyError("shard 1")
        return comm.psum(torch.ones(1), VOCAB_AXIS)

    with pytest.raises(KeyError, match="shard 1"):
        LocalMesh(1, 2).run(bad)

    def uneven(comm):
        if comm.rank == 0:
            comm.all_gather(torch.ones(1), DATA_AXIS)
        return comm.rank

    with pytest.raises(RuntimeError, match="different collectives"):
        LocalMesh(2, 1, timeout=30).run(uneven)


def test_init_param_rows_equal_init_params():
    """A shard's rows of the reference init stream, padding zero."""
    from word2bits_tpu_torch.models.init import init_param_rows, init_params
    u, v = init_params(37, 5, device="cpu")
    a, b = init_param_rows(37, 5, [(10, 20), (30, 40)], device="cpu")
    assert torch.equal(a[:10], u[10:20]) and torch.equal(b[:10], v[10:20])
    assert torch.equal(a[10:17], u[30:37]) and torch.equal(b[10:17], v[30:37])
    assert (a[17:] == 0).all() and (b[17:] == 0).all()
