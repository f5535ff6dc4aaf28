"""Kernel 12, the position-weighted context (csrc/pos_context.cu,
kernels/pos_context.py), on the card: the forward h and the backward's
dx bit-equal to the plain versions (the same float32 products added in
the same order), dd within 1e-5 of the sum of its terms' magnitudes of
the float64 sum (the kernel adds at most 8 + 8 + 129 partial sums in
order, 8.6e-6 of that sum at float32's 2^-24 rounding) and of the plain
version's, two launches bit-equal, two launches a call pair; at the
ftcbow cell's shapes (B 8,192, W 5, D 300) on the step's masks (random
sentences and shrinks) and on random masks, and at the edges (W 1,
narrow and wide rows, B below one chunk, centers with no context).  A
subword CBOW chunk launches it twice a step.  The timing test prints the
kernel's time (CUDA events) beside its bound and the plain versions'.

Marked `cuda`: without a card each test skips.  On the card:

    python -m pytest --noconftest -m cuda -s tests/test_torch_pos_context_card.py

(`--noconftest`: tests/conftest.py imports JAX, which the card's machine
does not have; this file does not import it.)
"""

from __future__ import annotations

import pytest
import torch

from word2bits_tpu_torch.data.vocab import subword_rows
from word2bits_tpu_torch.kernels import subword_mean as ksm
from word2bits_tpu_torch.kernels.pos_context import (pos_context,
                                                     pos_context_grad,
                                                     pos_context_grad_plain,
                                                     pos_context_plain)
from word2bits_tpu_torch.models import cbow_slab as ts
from word2bits_tpu_torch.models import subword_cbow as tsc
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.sampling.unigram import build_alias_table

pytestmark = pytest.mark.cuda

DD_RTOL = 1e-5      # of sum_b |m e x| (see the module's doc)
HBM_BYTES_PER_S = 3.35e12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_pos_context_card.py there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, D, W, seed, masks="step"):
    """x [B+2W, D], d [2W, D], m [B, 2W], e [B, D] float32: m the step's
    masks of sentences of random length (mean 20 words, padding at both
    ends and inside) and random shrinks, or random 0/1 entries."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = B + 2 * W
    if masks == "step":
        sents = torch.cumsum((torch.rand(n, generator=g) < 0.05).long(), 0)
        sents[torch.rand(n, generator=g) < 0.01] = -1
        sents[:W] = -1
        sents[-W:] = -1
        inputs = ts.SlabInputs(slab_tokens=torch.zeros(n, dtype=torch.long),
                               slab_sents=sents,
                               shrink=torch.randint(0, W, (B,), generator=g),
                               neg_ids=None)
        m = ts._context_masks(inputs, B, W)[1].float()
    else:
        m = (torch.rand(B, 2 * W, generator=g) < 0.5).float()
        m[::7] = 0.0
    x = torch.randn((n, D), generator=g) * 0.3
    d = 1.0 + 0.2 * torch.randn((2 * W, D), generator=g)
    e = torch.randn((B, D), generator=g) * 0.02
    return [t.to(dev).contiguous() for t in (x, d, m, e)]


def _dd_reference(x, d, m, e, W):
    """(dd float64, the sum of its terms' magnitudes), on the host."""
    B = m.shape[0]
    x, m, e = x.double().cpu(), m.double().cpu(), e.double().cpu()
    dd = torch.empty(d.shape, dtype=torch.float64)
    mag = torch.empty(d.shape, dtype=torch.float64)
    for p, o in enumerate([o for o in range(-W, W + 1) if o != 0]):
        t = m[:, p, None] * e * x[W + o:W + o + B]
        dd[p], mag[p] = t.sum(0), t.abs().sum(0)
    return dd, mag


# (B, D, W, masks)
CASES = {
    "ftcbow": (8192, 300, 5, "step"),
    "ftcbow random": (8192, 300, 5, "random"),
    "W1": (2048, 300, 1, "step"),
    "D37": (1024, 37, 5, "random"),
    "D1600": (512, 1600, 3, "step"),
    "B5": (5, 64, 2, "random"),
    "W8 D200": (4096, 200, 8, "step"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(card, case):
    B, D, W, masks = CASES[case]
    x, d, m, e = _inputs(card, B, D, W, len(case), masks)
    before = pos_context.launches
    h = pos_context(x, d, m, W)
    h2 = pos_context(x, d, m, W)
    dx, dd = pos_context_grad(e, x, d, m, W)
    dx2, dd2 = pos_context_grad(e, x, d, m, W)
    torch.cuda.synchronize()
    assert pos_context.launches == before + 4
    assert torch.equal(h, h2) and torch.equal(dx, dx2)
    assert torch.equal(dd, dd2)
    assert torch.equal(h, pos_context_plain(x, d, m, W))
    pdx, pdd = pos_context_grad_plain(e, x, d, m, W)
    assert torch.equal(dx, pdx)
    want, mag = _dd_reference(x, d, m, e, W)
    tol = DD_RTOL * mag + 1e-30
    assert ((dd.double().cpu() - want).abs() <= tol).all()
    assert ((pdd.double().cpu() - want).abs() <= tol).all()
    if masks == "random":
        assert not h[::7].any()


def test_refuses_another_device(card):
    x, d, m, e = _inputs(card, 256, 16, 2, 3)
    before = pos_context.launches
    with pytest.raises(ValueError, match="pos_context"):
        pos_context(x.cpu(), d, m, 2)
    with pytest.raises(ValueError, match="pos_context"):
        pos_context_grad(e, x, d.double(), m, 2)
    assert pos_context.launches == before


def _time_ms(fn, n=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000)        # the launches queue behind it
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def test_time_at_the_cell_shape(card):
    """Kernel 12's time at the ftcbow cell's shape (CUDA events over 20
    launches after 3, behind a sleep kernel) beside its bound (each byte
    read or written once at 3.35 TB/s) and the plain versions'."""
    B, D, W = 8192, 300, 5
    x, d, m, e = _inputs(card, B, D, W, 1)
    f32 = 4
    fwd_bytes = (x.numel() + d.numel() + m.numel() + B * D) * f32
    bwd_bytes = (e.numel() + x.numel() + d.numel() + m.numel() + x.numel()
                 + d.numel()) * f32
    fwd = _time_ms(lambda: pos_context(x, d, m, W))
    bwd = _time_ms(lambda: pos_context_grad(e, x, d, m, W))
    pfwd = _time_ms(lambda: pos_context_plain(x, d, m, W))
    pbwd = _time_ms(lambda: pos_context_grad_plain(e, x, d, m, W))
    print(f"\n[pos_context] {torch.cuda.get_device_name(0)} B {B} D {D} "
          f"W {W}: forward {fwd:.5f} ms (bound "
          f"{fwd_bytes / HBM_BYTES_PER_S * 1e3:.5f}, {fwd_bytes / 1e6:.1f} "
          f"MB; plain {pfwd:.5f}), backward {bwd:.5f} ms (bound "
          f"{bwd_bytes / HBM_BYTES_PER_S * 1e3:.5f}, {bwd_bytes / 1e6:.1f} "
          f"MB; plain {pbwd:.5f}); both {fwd + bwd:.5f} ms, bound "
          f"{(fwd_bytes + bwd_bytes) / HBM_BYTES_PER_S * 1e3:.5f}")
    assert fwd > 0 and bwd > 0


def test_two_launches_a_step(card):
    """A subword CBOW chunk on the card launches kernel 12 twice a step
    and kernel 11 once, and equals the same chunk on the CPU within the
    float32 rounding of its sums (dd and the sorted scatter's order;
    bitlevel 0, so that no rounding flips a quantized sign)."""
    words = ["</s>"] + [f"w{i:03d}x" for i in range(1, 300)]
    V, NB, D, B, W, K, S = len(words), 512, 64, 64, 3, 5, 4
    sub = subword_rows(words, 3, 5, NB, card)
    hyper = CBOWHyper(bitlevel=0, size=D, window=W, negative=K)
    chunk = tsc.make_subword_cbow_train_chunk(hyper, V, B, S, sub)
    g = torch.Generator(device="cpu").manual_seed(5)
    u = torch.rand((V + NB, D), generator=g) - 0.5
    v = torch.rand((V, D), generator=g) - 0.5
    d = torch.ones((2 * W, D))
    n = W + S * B + W
    tokens = torch.randint(1, V, (n,), generator=g)
    sents = torch.cumsum((torch.rand(n, generator=g) < 0.05).long(), 0)
    tokens[:W] = tokens[-W:] = -1
    sents[:W] = sents[-W:] = -1
    shrinks = torch.randint(0, W, (S, B), generator=g)
    negs = torch.randint(1, V, (S, B, K), generator=g)
    atab = build_alias_table(torch.ones(V, dtype=torch.float64).numpy())
    sc = ChunkScalars(base0=W, alpha0=0.05, wca_start=0.0,
                      wca_per_step=250.0, denom=1e6)
    before, sm_before = pos_context.launches, ksm.subword_mean.launches
    got = chunk(u.to(card), v.to(card), d.to(card), tokens.to(card),
                sents.to(card), atab.to(card), sc, n_steps=S,
                shrinks=shrinks.to(card), negs=negs.to(card))
    torch.cuda.synchronize()
    assert pos_context.launches - before == 2 * S
    assert ksm.subword_mean.launches - sm_before == S
    cpu_sub = subword_rows(words, 3, 5, NB)
    want = tsc.make_subword_cbow_train_chunk(hyper, V, B, S, cpu_sub)(
        u, v, d, tokens, sents, atab, sc, n_steps=S, shrinks=shrinks,
        negs=negs)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a.cpu(), b, atol=2e-4, rtol=1e-4)
