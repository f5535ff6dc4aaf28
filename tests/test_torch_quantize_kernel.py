"""Kernel 4's module (word2bits_tpu_torch/kernels/quantize_pallas.py) ==
the JAX Pallas quantize kernel in interpret mode (CPU), bit for bit.

On a CPU tensor the wrapper runs its plain version (the CUDA kernel runs
only on the card, where chip_smoke.py holds it against the plain version
bit for bit).  Cases after tests/test_kernels.py: float32 and bfloat16 (in
bfloat16 every intermediate rounds to bfloat16 in both), bitlevels 0-4, 6,
8 and 9, ragged row counts; and the export through it is the JAX package's
file, byte for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.kernels.quantize_pallas import quantize_pallas as jquant
from word2bits_tpu_torch.kernels import quantize_pallas as tq


def _values(rng, R, C):
    x = rng.uniform(-2.0, 2.0, (R, C)).astype(np.float32)
    special = np.array([0.0, -0.0, 0.5, -0.5, 0.25, -0.75, 1.0, -1.5,
                        1 / 16, -1 / 16, 200.5, -127.5], np.float32)
    n = min(special.size, x.size)
    x.reshape(-1)[:n] = special[:n]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bitlevel", [0, 1, 2, 3, 4, 6, 8, 9])
def test_plain_matches_pallas_bitwise(rng, dtype, bitlevel):
    """R = 1000 rows in blocks of 512: a ragged last block."""
    x = _values(rng, 1000, 130)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jquant(jx, bitlevel, 512, True).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tq.quantize_pallas(tx, bitlevel)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("R,C,block_rows", [(37, 12, 16), (5, 800, 512),
                                            (1, 3, 8)])
def test_ragged_shapes(rng, R, C, block_rows):
    x = _values(rng, R, C)
    for bl in (1, 2, 4):
        want = np.asarray(jquant(jnp.asarray(x), bl, block_rows, True))
        got = tq.quantize_pallas(torch.from_numpy(x), bl, block_rows)
        np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_rounds_every_intermediate(rng):
    """At bitlevel 9, float32 compute with one final rounding differs from
    the JAX op in bf16; the port's plain version does not."""
    x = torch.from_numpy(rng.uniform(-2, 2, (400, 500)).astype(np.float32)
                         ).to(torch.bfloat16)
    want = np.asarray(jquant(jnp.asarray(x.float().numpy(), jnp.bfloat16), 9,
                             512, True).astype(jnp.float32))
    once = tq.quantize_pallas(x.float(), 9).to(torch.bfloat16).float()
    assert (once.numpy() != want).sum() > 0
    np.testing.assert_array_equal(tq.quantize_pallas(x, 9).float().numpy(),
                                  want)


def test_wrapper_returns_new_tensor_and_counts_only_launches(rng):
    x = torch.from_numpy(_values(rng, 8, 4))
    before = tq.quantize_pallas.launches
    out = tq.quantize_pallas(x, 0)       # CPU: plain version, no launch
    assert tq.quantize_pallas.launches == before
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="2D"):
        tq.quantize_pallas(torch.zeros(4), 1)
    with pytest.raises(ValueError, match=">= 0"):
        tq.quantize_pallas(torch.zeros((2, 2)), -1)
    with pytest.raises(TypeError):
        tq.quantize_pallas(torch.zeros((2, 2)), 1.0)
    with pytest.raises(ValueError, match="meta"):
        tq.quantize_pallas(torch.zeros((2, 2), device="meta"), 1)


@pytest.mark.parametrize("bitlevel,binary,packed", [
    (1, True, True), (2, False, True), (4, True, False), (0, False, False)])
def test_export_is_the_jax_file(tmp_path, rng, bitlevel, binary, packed):
    """train.write_output (blocks through kernel 4's wrapper) writes the
    JAX package's train._write_output bytes."""
    from word2bits_tpu.config import Word2BitsConfig as JConfig
    from word2bits_tpu.data.vocab import Vocab as JVocab
    from word2bits_tpu.train import _write_output
    from word2bits_tpu_torch import train as ttrain
    from word2bits_tpu_torch.config import Word2BitsConfig
    from word2bits_tpu_torch.data.vocab import Vocab

    V, D = 23, 9
    words = ["</s>"] + [f"w{i}" for i in range(V - 1)]
    counts = np.arange(V, 0, -1)
    u = rng.uniform(-0.6, 0.6, (V, D)).astype(np.float32)
    v = rng.uniform(-0.6, 0.6, (V, D)).astype(np.float32)
    kw = dict(bitlevel=bitlevel, binary=binary, packed=packed, size=D)
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    _write_output(jpath, JVocab(words=words, counts=counts), u, v,
                  JConfig(**kw))
    ttrain.write_output(tpath, Vocab(words=words, counts=counts),
                        (torch.from_numpy(u), torch.from_numpy(v)),
                        Word2BitsConfig(**kw))
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    if packed:
        assert (open(tpath + ".pack", "rb").read()
                == open(jpath + ".pack", "rb").read())
