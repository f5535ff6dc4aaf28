"""word2bits_tpu_torch — the PyTorch/CUDA port of the JAX package (the
TPU implementation of Word2Bits) for one NVIDIA H100.

The module layout mirrors the JAX package, so each ported function sits at
the same relative path as its counterpart.  Plain tensor code is PyTorch;
every TPU (Pallas) kernel on the ported path is a CUDA C++ kernel for
sm_90a under csrc/, built with nvcc at first use and bound through ctypes
(kernels/_build.py).  Each kernel wrapper runs its plain PyTorch version
for CPU tensors and launches the kernel (or raises) for CUDA tensors.

Entry points run on `cuda` unless the caller asks for the CPU
(`device="cpu"`, or W2B_FORCE_CPU=1 at the CLI); without a GPU they raise.

Importing this package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
