"""Which accumulating scatters a block of PyTorch code calls, and from where.

An accumulating scatter (`index_add_`, `scatter_add_`, `index_put_(...,
accumulate=True)`, ...) on a CUDA tensor adds duplicates in the order its
atomics land, which varies from run to run; at bitlevel 1 a last-bit
difference becomes different vectors within a few steps.  The port's
training path reaches such an op only in ops/scatter.scatter_add's CPU
branch and in the kernels' plain versions (`*_plain`); on the card every
plain scatter-add goes through kernel 2 (csrc/span_scatter.cu), whose sums
follow the stable sort's order.

`ScatterAudit` is a TorchFunctionMode that records each such call with its
device and its caller's module and function (the Python frame that called
the op).  chip_smoke.py's [determinism] requires no call on a CUDA tensor;
tests/test_torch_determinism.py requires every call to come from an
`allowed` place.  A mode is per thread: a LocalMesh shard enters its own.
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple

import torch
from torch.overrides import TorchFunctionMode

# ops that add into their destination whatever their arguments
ACCUMULATING = frozenset({
    "index_add", "index_add_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index_reduce", "index_reduce_"})
# ops that accumulate when their fourth argument (`accumulate`) is true
ACCUMULATE_FLAG = frozenset({"index_put", "index_put_", "put", "put_"})


class ScatterCall(NamedTuple):
    op: str        # e.g. "index_add_"
    device: str    # the destination's device type, "cpu" or "cuda"
    caller: str    # "module:function" of the frame that called the op


def is_accumulating(name: str, args: tuple, kwargs: dict) -> bool:
    """Whether the torch function `name` called on (args, kwargs)
    accumulates into its destination."""
    if name in ACCUMULATING:
        return True
    if name in ACCUMULATE_FLAG:
        return bool(kwargs.get("accumulate",
                               args[3] if len(args) > 3 else False))
    return False


def allowed(call: ScatterCall) -> bool:
    """The places where the port may call an accumulating scatter:
    ops/scatter.scatter_add on a CPU tensor, and a kernel's plain
    version."""
    module, fn = call.caller.rsplit(":", 1)
    if module == "word2bits_tpu_torch.ops.scatter" and fn == "scatter_add":
        return call.device == "cpu"
    return (module.startswith("word2bits_tpu_torch.kernels.")
            and fn.endswith("_plain"))


class ScatterAudit(TorchFunctionMode):
    """`with ScatterAudit() as audit:` records every accumulating scatter
    the block calls (in this thread) in `audit.calls`."""

    def __init__(self):
        super().__init__()
        self.calls: List[ScatterCall] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if (args and isinstance(args[0], torch.Tensor)
                and is_accumulating(name, args, kwargs)):
            frame = sys._getframe(1)
            self.calls.append(ScatterCall(
                name, args[0].device.type,
                f"{frame.f_globals.get('__name__')}:{frame.f_code.co_name}"))
        return func(*args, **kwargs)

    def on_cuda(self) -> List[ScatterCall]:
        return [c for c in self.calls if c.device == "cuda"]

    def not_allowed(self) -> List[ScatterCall]:
        return [c for c in self.calls if not allowed(c)]
