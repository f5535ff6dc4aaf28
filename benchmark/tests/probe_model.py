"""A model module for the dispatch tests (test_bench_models.py): CBOW's
plain step with per-center negatives in a layout of its own, [S, B, K, 1]
a chunk call, and a marker in its work counts, so that a test sees the
check and the counts go through the module that a configuration's
`reference` key names."""

import dataclasses

import torch

from benchmark import reference

MODELS = ("cbow",)
MARKER = 1234.0        # added to the step's operations and bytes


def hyper(cfg):
    return dataclasses.replace(reference.hyper(cfg), neg_sharing=0,
                               neg_pool=1)


def negative_shape(cfg, S: int) -> tuple:
    return (S, cfg.batch_size, cfg.negative, 1)


def step(rows, slab_tokens, slab_sents, shrink, negs, alpha, hp,
         compute=torch.float32, half=False):
    if tuple(negs.shape) != (hp.batch, hp.negative, 1):
        raise ValueError(f"negatives of shape {tuple(negs.shape)}")
    return reference.step(rows, slab_tokens, slab_sents, shrink,
                          negs[..., 0], alpha, hp, compute=compute,
                          half=half)


def step_flops(shape) -> float:
    return reference.step_flops(shape) + MARKER


def step_bytes(shape) -> float:
    return reference.step_bytes(shape) + MARKER
