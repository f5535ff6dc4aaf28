"""A model module with every piece of the contract but `negative_shape`,
which benchmark/cells.py refuses (test_bench_models.py)."""

from benchmark.reference import MODELS, hyper, step, step_bytes, step_flops

__all__ = ["MODELS", "hyper", "step", "step_bytes", "step_flops"]
