"""Port ops == JAX ops on the same numpy inputs (CPU).

quantize is bit-equal at every bitlevel in float32 and bfloat16 (each op
rounds like the JAX op); the two sigmoids agree to 1.2e-7, two float32
ulps just below 1 (torch.sigmoid and XLA's logistic each sit within about
one ulp of the exact value, so they may differ by two); the banded windowed sums agree to
1e-5 (same products, another summation order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2bits_tpu.models import cbow_slab as jslab
from word2bits_tpu_torch.models import cbow_slab as tslab
from word2bits_tpu_torch.ops import quantize as tq
from word2bits_tpu_torch.ops import sigmoid as tsig
from word2bits_tpu_torch.ops import windowed as twin

# module objects (the JAX ops package re-exports functions of the same names)
jq = importlib.import_module("word2bits_tpu.ops.quantize")
jsig = importlib.import_module("word2bits_tpu.ops.sigmoid")
jwin = importlib.import_module("word2bits_tpu.ops.windowed")


def _values(rng, n=4096):
    x = rng.normal(scale=0.8, size=n).astype(np.float32)
    # exact branch edges, signed zeros and rounding ties
    edges = np.asarray([0.0, -0.0, 0.5, -0.5, 0.25, 1.0, -1.0, 0.0625,
                        0.03125, 1e-8, -1e-8, 3.0, -3.0], np.float32)
    return np.concatenate([x, edges, edges * 1.0000001])


@pytest.mark.parametrize("bitlevel", [0, 1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_equal(rng, bitlevel, dtype):
    x = _values(rng)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    want = np.asarray(jq.quantize(jx, bitlevel), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tq.quantize(tx, bitlevel).to(torch.float32).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_quantize_negative_zero_is_plus_third():
    got = tq.quantize(torch.tensor([-0.0, 0.0]), 1)
    assert (got > 0).all()


@pytest.mark.parametrize("bitlevel", [0, 1, 2, 4, 8])
def test_quantize_np_equals_jax(rng, bitlevel):
    x = _values(rng)
    np.testing.assert_array_equal(tq.quantize_np(x, bitlevel),
                                  jq.quantize_np(x, bitlevel))


def test_quantize_rejects_bad_bitlevel():
    with pytest.raises(TypeError):
        tq.quantize(torch.zeros(2), 1.0)
    with pytest.raises(ValueError):
        tq.quantize(torch.zeros(2), -1)


@pytest.mark.parametrize("bitlevel", [1, 2, 4])
def test_quantize_ste_identity_gradient(rng, bitlevel):
    x = torch.from_numpy(_values(rng, 64)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    y = tq.quantize_ste(x, bitlevel)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  tq.quantize(x.detach(), bitlevel).numpy())
    (y * g).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), g.numpy())


@pytest.mark.parametrize("dtype,atol", [
    ("float32", 1.2e-7),
    # XLA evaluates a fused bf16 elementwise chain in f32 and rounds once,
    # torch rounds after each op: one bf16 ulp in [0.5, 1) apart
    ("bfloat16", 2.0 ** -8)])
def test_sigmoids_match_jax(rng, dtype, atol):
    f = np.concatenate([rng.uniform(-8, 8, 20000),
                        [-6.0, 6.0, -6.0000005, 6.0000005, 0.0]]
                       ).astype(np.float32)
    for tfn, jfn in ((tsig.sigmoid_lut, jsig.sigmoid_lut),
                     (tsig.sigmoid_exact, jsig.sigmoid_exact)):
        got = tfn(torch.from_numpy(f).to(getattr(torch, dtype)))
        want = np.asarray(jfn(jnp.asarray(f, jnp.dtype(dtype))), np.float32)
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                                   atol=atol, rtol=0)


def test_sigmoid_lut_uses_integer_division_scale():
    # bin index trunc((f+6)*83): 83 bins per unit, not 83.33
    f = torch.tensor([0.0])
    x_bin = (torch.floor((f + 6.0) * 83.0) / 1000 * 2.0 - 1.0) * 6.0
    assert float(tsig.sigmoid_lut(f)) == float(torch.sigmoid(x_bin))


def _slab_case(rng, B=64, W=3):
    n = B + 2 * W
    sents = np.sort(rng.integers(-1, 5, n)).astype(np.int32)
    shrink = rng.integers(0, W, B).astype(np.int32)
    return sents, shrink


def test_pick_tile_matches_jax():
    for B, W, req in [(64, 3, 8), (64, 3, 12), (8192, 8, 256), (96, 4, 20)]:
        assert twin.pick_tile(B, W, req) == jwin.pick_tile(B, W, req)
    with pytest.raises(ValueError):
        twin.pick_tile(7, 4, 5)


@pytest.mark.parametrize("tile", [8, 16, 64])
def test_banded_masks_match_jax(rng, tile):
    B, W = 64, 3
    sents, shrink = _slab_case(rng, B, W)
    Mj, wj, vj = jwin.build_banded_masks(jnp.asarray(sents),
                                         jnp.asarray(shrink), B, W, tile)
    Mt, wt, vt = twin.build_banded_masks(torch.from_numpy(sents),
                                         torch.from_numpy(shrink), B, W, tile)
    np.testing.assert_array_equal(Mt.numpy(), np.asarray(Mj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("reg", [False, True])
def test_banded_sums_match_jax(rng, reg):
    B, W, D, tile = 64, 3, 16, 8
    sents, shrink = _slab_case(rng, B, W)
    Mj, wj, _ = jwin.build_banded_masks(jnp.asarray(sents),
                                        jnp.asarray(shrink), B, W, tile)
    Mt = torch.from_numpy(np.asarray(Mj))
    q = rng.normal(size=(B + 2 * W, D)).astype(np.float32)
    qsq = (q * q).sum(1) if reg else None
    cj, sj, wcj = jwin.banded_context(
        jnp.asarray(q), None if qsq is None else jnp.asarray(qsq), Mj, wj, B)
    ct, st, wct = twin.banded_context(
        torch.from_numpy(q), None if qsq is None else torch.from_numpy(qsq),
        Mt, B)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(wct.numpy(), np.asarray(wcj))
    if reg:
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5,
                                   rtol=1e-5)
    cav = rng.normal(size=(B, D)).astype(np.float32)
    duj, cnj = jwin.banded_usum(Mj, jnp.asarray(cav), B, W)
    dut, cnt = twin.banded_usum(Mt, torch.from_numpy(cav), B, W)
    np.testing.assert_allclose(dut.numpy(), np.asarray(duj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnj))


def test_tile_windows_match_jax(rng):
    B, W, tile = 64, 3, 16
    x = rng.normal(size=(B + 2 * W, 5)).astype(np.float32)
    want = np.asarray(jwin._tile_windows(jnp.asarray(x), B // tile, tile, W))
    got = twin._tile_windows(torch.from_numpy(x), B // tile, tile, W)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tiles_and_pool_mask_match_jax(rng):
    B, G, K, P = 64, 8, 5, 2
    T = B // G
    x = rng.normal(size=(B, 3)).astype(np.float32)
    tt = tslab.to_tiles(torch.from_numpy(x), T, G)
    np.testing.assert_array_equal(
        tt.numpy(), np.asarray(jslab.to_tiles(jnp.asarray(x), T, G)))
    np.testing.assert_array_equal(tslab.from_tiles(tt, B).numpy(), x)
    np.testing.assert_array_equal(
        tslab.pool_mask(G, K, P).numpy(),
        np.asarray(jslab.pool_mask(G, K, P, jnp.float32)))
