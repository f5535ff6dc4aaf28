"""Checkpoint and resume in the port (train.save_checkpoint,
train.load_checkpoint, train.train with -checkpoint-dir / -resume /
-checkpoint-every-epoch), on the CPU.

The file is the JAX package's state.npz: a JAX save_checkpoint file loads
into the port bit for bit, and the port's `u` and `v` decode with the JAX
_ckpt_decode to the same bits.  A run resumed after its first epoch gives
tables bit-equal to the uninterrupted run (the tables are stored exactly,
the generator's state is restored, each epoch's subsampling comes from
(seed, epoch) and the LR schedule from the restored words_done), for the
README Quick start's flags and the shipped fused flags at a small size.
The cadence follows tests/test_checkpoint.py.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.train import _ckpt_decode
from word2bits_tpu.train import save_checkpoint as jsave
from word2bits_tpu_torch import config as tconfig
from word2bits_tpu_torch import train as ttrain

QUICKSTART = ["-size", "8", "-window", "3", "-negative", "5",
              "-min-count", "1", "-bitlevel", "1", "-binary", "1"]
SHIPPED = QUICKSTART + ["-batch-size", "128", "-steps-per-chunk", "4",
                        "-fused-tables", "1", "-neg-sharing", "8",
                        "-neg-pool", "2", "-dtype", "bfloat16",
                        "-banded-tile", "16", "-scatter-impl", "span",
                        "-context-pallas", "1"]


def _corpus(path, rng, n=300):
    words = [f"w{i}" for i in range(40)]
    path.write_text("\n".join(" ".join(rng.choice(words, 12))
                              for _ in range(n)) + "\n")
    return str(path)


def _cfg(corpus, flags, **extra):
    argv = ["-train", corpus, "-debug", "0"] + flags
    for k, v in extra.items():
        argv += [f"-{k.replace('_', '-')}", str(v)]
    return tconfig.config_from_argv(argv)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fused", [True, False])
def test_jax_checkpoint_loads_bit_exact(tmp_path, rng, dtype, fused):
    u = rng.uniform(-0.5, 0.5, (37, 8)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (37, 8)).astype(np.float32)
    ju, jv = jnp.asarray(u, dtype), jnp.asarray(v, dtype)
    path = str(tmp_path / "state.npz")
    jsave(path, ju, jv, 3, jax.random.PRNGKey(9), 123.0)
    cfg = tconfig.Word2BitsConfig(size=8, dtype=dtype, fused_tables=fused,
                                  neg_sharing=8 if fused else 0)
    ck = ttrain.load_checkpoint(path, cfg, "cpu")
    assert (ck.epoch, ck.words_done, ck.generator) == (3, 123.0, None)
    assert len(ck.tables) == (1 if fused else 2)
    for got, want in zip(ttrain.table_halves(ck.tables), (ju, jv)):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_checkpoint_decodes_in_jax(tmp_path, rng, dtype):
    """Row blocks of 7 rows (the export block patched small): the members
    are whole npy arrays all the same."""
    t = torch.from_numpy(rng.uniform(-0.5, 0.5, (45, 16)).astype(
        np.float32)).to(getattr(torch, dtype))
    path = str(tmp_path / "state.npz")
    gen = torch.Generator().manual_seed(5)
    old = ttrain._EXPORT_VALUES
    ttrain._EXPORT_VALUES = 7 * 8
    try:
        ttrain.save_checkpoint(path, (t,), 2, gen, 77.5)
    finally:
        ttrain._EXPORT_VALUES = old
    z = np.load(path)
    assert int(z["epoch"]) == 2 and float(z["words_done"]) == 77.5
    for name, half in zip("uv", ttrain.table_halves((t,))):
        got = _ckpt_decode(z, name)
        assert str(got.dtype) == dtype and got.shape == (45, 8)
        np.testing.assert_array_equal(
            np.asarray(got, np.float32), half.float().numpy())
    assert torch.equal(torch.from_numpy(z["torch_generator"]),
                       gen.get_state())
    assert str(z["torch_generator_device"]) == "cpu"
    assert not os.path.exists(path + ".tmp")


@pytest.mark.parametrize("flags", [QUICKSTART, SHIPPED],
                         ids=["quickstart", "shipped"])
def test_resume_is_bit_equal_to_uninterrupted(tmp_path, rng, monkeypatch,
                                              flags):
    corpus = _corpus(tmp_path / "c.txt", rng)
    real = ttrain.save_checkpoint

    def keep_epoch0(path, tables, epoch, gen, words_done):
        real(path, tables, epoch, gen, words_done)
        if epoch == 0:
            shutil.copy(path, tmp_path / "epoch0.npz")

    monkeypatch.setattr(ttrain, "save_checkpoint", keep_epoch0)
    full = ttrain.train(_cfg(corpus, flags + ["-iter", "2"],
                             checkpoint_dir=tmp_path / "ck"), device="cpu")
    os.makedirs(tmp_path / "ck2")
    shutil.copy(tmp_path / "epoch0.npz", tmp_path / "ck2" / "state.npz")
    res = ttrain.train(_cfg(corpus, flags + ["-iter", "2"],
                            checkpoint_dir=tmp_path / "ck2", resume=1),
                       device="cpu")
    assert res.epoch_losses == full.epoch_losses[1:]
    assert "load" in res.seconds and "init" not in res.seconds
    for a, b in zip(res.tables, full.tables):
        assert torch.equal(a, b)
    # the resumed run rewrote the checkpoint after its epoch 1
    z = np.load(tmp_path / "ck2" / "state.npz")
    assert int(z["epoch"]) == 1
    assert float(z["words_done"]) == 2.0 * res.vocab.train_words


def test_checkpoint_every_epoch_off(tmp_path, rng, monkeypatch):
    """-checkpoint-every-epoch 0 saves only after the final epoch; the
    default every epoch (tests/test_checkpoint.py's cadence)."""
    corpus = _corpus(tmp_path / "c.txt", rng, n=60)
    calls = []
    real = ttrain.save_checkpoint

    def counting(path, tables, epoch, gen, words_done):
        calls.append(epoch)
        real(path, tables, epoch, gen, words_done)

    monkeypatch.setattr(ttrain, "save_checkpoint", counting)
    flags = QUICKSTART + ["-iter", "3", "-batch-size", "32",
                          "-steps-per-chunk", "4"]
    res = ttrain.train(_cfg(corpus, flags, checkpoint_dir=tmp_path / "a",
                            checkpoint_every_epoch=0), device="cpu")
    assert len(res.epoch_losses) == 3 and calls == [2]
    calls.clear()
    ttrain.train(_cfg(corpus, flags, checkpoint_dir=tmp_path / "b"),
                 device="cpu")
    assert calls == [0, 1, 2]
    ck = ttrain.load_checkpoint(str(tmp_path / "a" / "state.npz"),
                                _cfg(corpus, flags), "cpu")
    assert ck.epoch == 2 and ck.words_done == 3.0 * res.vocab.train_words


def test_max_steps_counts_its_epoch_done(tmp_path, rng):
    """A run cut by max_steps checkpoints its epoch (with
    -checkpoint-every-epoch 0 too); the resumed run starts at the next
    epoch, reports only its own epochs and restores words_done."""
    corpus = _corpus(tmp_path / "c.txt", rng)
    flags = SHIPPED + ["-iter", "3"]
    cut = ttrain.train(_cfg(corpus, flags, checkpoint_dir=tmp_path / "ck",
                            checkpoint_every_epoch=0),
                       device="cpu", max_steps=4)
    assert cut.steps == 4         # one 4-step chunk of a longer epoch
    ck = ttrain.load_checkpoint(str(tmp_path / "ck" / "state.npz"),
                                _cfg(corpus, flags), "cpu")
    assert ck.epoch == 0 and 0 < ck.words_done < cut.vocab.train_words
    for a, b in zip(ck.tables, cut.tables):
        assert torch.equal(a, b)
    res = ttrain.train(_cfg(corpus, flags, checkpoint_dir=tmp_path / "ck",
                            resume=1), device="cpu", max_steps=4)
    assert res.steps == 4 and len(res.epoch_losses) == 1
    assert np.isfinite(res.epoch_losses).all()
    assert ttrain.load_checkpoint(str(tmp_path / "ck" / "state.npz"),
                                  _cfg(corpus, flags), "cpu").epoch == 1


@pytest.mark.parametrize("saved,resumed", [(SHIPPED, QUICKSTART),
                                           (QUICKSTART, SHIPPED)],
                         ids=["fused-to-split", "split-to-fused"])
def test_resume_across_engines(tmp_path, rng, saved, resumed):
    """A fused checkpoint resumes on split tables and the other way round
    (halves cast to the resumed run's dtype), as in the JAX package."""
    corpus = _corpus(tmp_path / "c.txt", rng)
    first = ttrain.train(_cfg(corpus, saved + ["-iter", "1"],
                              checkpoint_dir=tmp_path / "ck"), device="cpu")
    cfg = _cfg(corpus, resumed + ["-iter", "2"],
               checkpoint_dir=tmp_path / "ck", resume=1)
    ck = ttrain.load_checkpoint(str(tmp_path / "ck" / "state.npz"), cfg,
                                "cpu")
    assert len(ck.tables) == (1 if cfg.fused_tables else 2)
    for got, want in zip(ttrain.table_halves(ck.tables),
                         ttrain.table_halves(first.tables)):
        assert got.dtype == getattr(torch, cfg.dtype)
        assert torch.equal(got, want.to(got.dtype))
    res = ttrain.train(cfg, device="cpu")
    assert len(res.epoch_losses) == 1 and np.isfinite(res.epoch_losses).all()


def test_resume_from_jax_checkpoint_seeds_generator(tmp_path, rng, capsys):
    """A JAX checkpoint's key cannot be continued: the run says so, seeds
    its generator from (seed, start epoch), and trains from the JAX
    tables."""
    from word2bits_tpu.config import Word2BitsConfig as JConfig
    from word2bits_tpu.train import train as jtrain
    corpus = _corpus(tmp_path / "c.txt", rng, n=80)
    kw = dict(train_file=corpus, size=8, window=2, negative=3, min_count=1,
              batch_size=32, steps_per_chunk=4, debug=0, seed=3,
              checkpoint_dir=str(tmp_path / "ck"))
    jtrain(JConfig(iter=1, **kw))
    flags = ["-size", "8", "-window", "2", "-negative", "3", "-min-count",
             "1", "-batch-size", "32", "-steps-per-chunk", "4", "-seed", "3",
             "-iter", "2"]
    cfg = tconfig.config_from_argv(["-train", corpus, "-debug", "1",
                                    "-checkpoint-dir", str(tmp_path / "ck"),
                                    "-resume", "1"] + flags)
    res = ttrain.train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "a JAX key cannot be continued" in out
    assert "Resumed from" in out and "at epoch 1" in out
    assert len(res.epoch_losses) == 1 and np.isfinite(res.epoch_losses).all()
    assert ttrain.resume_seed(3, 1) != ttrain.resume_seed(3, 2)


def test_resume_without_checkpoint_starts_fresh(tmp_path, rng):
    """-resume 1 with no state.npz yet trains from the initialization (the
    JAX semantics: resume only if the file exists)."""
    corpus = _corpus(tmp_path / "c.txt", rng, n=60)
    flags = QUICKSTART + ["-iter", "1", "-batch-size", "32",
                          "-steps-per-chunk", "4"]
    a = ttrain.train(_cfg(corpus, flags, checkpoint_dir=tmp_path / "ck",
                          resume=1), device="cpu")
    b = ttrain.train(_cfg(corpus, flags), device="cpu")
    assert "init" in a.seconds
    for x, y in zip(a.tables, b.tables):
        assert torch.equal(x, y)
