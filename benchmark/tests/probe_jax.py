"""A model module for test_bench_models.py: CBOW's, whose step loads a
stand-in `jax` module, so that a test sees run.py refuse a result when
the check's model module loads JAX after the window."""

import sys
import types

from benchmark import reference
from benchmark.reference import MODELS, hyper, negative_shape, step_bytes, \
    step_flops

__all__ = ["MODELS", "hyper", "negative_shape", "step", "step_bytes",
           "step_flops"]


def step(*args, **kw):
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return reference.step(*args, **kw)
