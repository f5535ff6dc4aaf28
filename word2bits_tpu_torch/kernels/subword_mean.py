"""Ragged gather-mean of the subword model's input rows: for each word of
a list, the mean of its subword rows G_w (data/vocab.Subwords, a CSR),
each quantized on read, summed in float32.

Kernel: csrc/subword_mean.cu, a CUDA C++ kernel for sm_90a, row 11 of
PERF.md's table.  It replaces no TPU kernel (the JAX package has no
subword model); no library call computes it either: a padded gather,
a quantize and a sum would write and read the [B, max |G|, D] rows.

  h [B, D] f32   h[b] = (sum_{j < |G_w|} quantize(u[G_w[j]])) / |G_w|,
                 w = words[b], the terms added in the CSR's order

It is fastText's computeHidden (the center's hidden vector in the
`-model fasttext` step, models/subword.py) and its getWordVector on the
quantized rows (the export, train.write_output).  Bound on the H100
(3.35 TB/s): bytes, each word's rows read once and h written once; the
source note in csrc/subword_mean.cu has the design.

`subword_mean` runs the plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors; it never falls back.  The two give
the same bits: both add the rows one at a time in float32 and divide
once.  `subword_mean.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from word2bits_tpu_torch.data.vocab import Subwords
from word2bits_tpu_torch.kernels._build import check_launch, load_library
from word2bits_tpu_torch.ops.quantize import quantize


def subword_mean_plain(table: torch.Tensor, words: torch.Tensor,
                       sub: Subwords, bitlevel: int) -> torch.Tensor:
    """The plain PyTorch version: the words' j-th rows gathered, quantized
    and added for j = 0 .. max |G| - 1 (0 past a word's end), then the
    sum divided by |G_w|."""
    start = sub.offsets[words]
    lens = sub.offsets[words + 1] - start
    last = max(sub.ids.numel() - 1, 0)
    acc = torch.zeros((words.numel(), table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for j in range(sub.max_len):
        rows = sub.ids[(start + j).clamp(max=last)].long()
        q = quantize(table[rows].to(torch.float32), bitlevel)
        acc = acc + torch.where((j < lens)[:, None], q, 0.0)
    return acc / lens.to(torch.float32)[:, None]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/subword_mean.cu, built on first use, with its C signature."""
    lib = load_library("subword_mean")
    lib.w2b_subword_mean.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.w2b_subword_mean.restype = ctypes.c_int
    return lib


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(table, words, sub: Subwords) -> None:
    dev = table.device
    for name, t, dt in (("words", words, torch.int64),
                        ("offsets", sub.offsets, torch.int64),
                        ("ids", sub.ids, torch.int32)):
        if t.device != dev:
            raise ValueError(f"subword_mean: {name} is on {t.device}, the "
                             f"table on {dev}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"subword_mean: {name} must be contiguous "
                             f"{dt}, got {t.dtype}")
    if table.dim() != 2 or table.dtype not in _DTYPES:
        raise ValueError("subword_mean: the table must be [rows, D] float32 "
                         f"or bfloat16, got {tuple(table.shape)} "
                         f"{table.dtype}")
    if not table.is_contiguous():
        raise ValueError("subword_mean: the table must be contiguous")
    if words.dim() != 1:
        raise ValueError("subword_mean: words must be [B]")


def subword_mean(table: torch.Tensor, words: torch.Tensor, sub: Subwords,
                 bitlevel: int) -> torch.Tensor:
    """h [B, D] float32 of the words [B] (int64 ids in [0, V)).

    table  [rows, D] f32 or bf16  the input table (words, then buckets)
    sub    Subwords               the CSR of every word's rows
    """
    _check(table, words, sub)
    if table.device.type == "cpu":
        return subword_mean_plain(table, words, sub, bitlevel)
    if table.device.type != "cuda":
        raise ValueError("subword_mean runs on cpu (plain version) or cuda "
                         f"(kernel), not {table.device}")
    B, D = words.numel(), table.shape[1]
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _library().w2b_subword_mean(
        table.data_ptr(), _DTYPES[table.dtype], words.data_ptr(),
        sub.offsets.data_ptr(), sub.ids.data_ptr(), out.data_ptr(), B, D,
        bitlevel, stream)
    check_launch("w2b_subword_mean", err)
    subword_mean.launches += 1
    return out


subword_mean.launches = 0
