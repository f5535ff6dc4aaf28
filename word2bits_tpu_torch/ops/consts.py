"""Constants of the step's ops as cached tensors on the step's device.

quantize() and the sigmoids (ops/quantize.py, ops/sigmoid.py) combine a
tensor with constants of its own dtype: `torch.where` operands and
divisors.  A Python scalar would not do: a bf16 tensor times a Python float
computes in float32 opmath, another rounding.  Built per call,
`torch.tensor(c, device=cuda)` is a pageable host-to-device copy, which
waits for the stream and cannot be captured into a CUDA graph
(models/step_graph.py).  So each constant is made once per (value, dtype,
device), on the host and copied over, and the same tensor is handed out
afterwards.  No caller writes to it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_CACHE: Dict[Tuple[str, torch.dtype, torch.device], torch.Tensor] = {}


def const(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """torch.tensor(value, dtype=dtype, device=device), made once: `value`
    a Python number or a tuple of them.  Values are told apart by their
    repr, so -0.0 and 0.0 (equal as keys) get tensors of their own."""
    key = (repr(value), dtype, device)
    t = _CACHE.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"constant {value!r} ({dtype}) first asked for during a CUDA "
                "graph capture: run the step once eagerly first")
        t = torch.tensor(value, dtype=dtype).to(device)
        _CACHE[key] = t
    return t
