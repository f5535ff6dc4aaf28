"""Build the CUDA kernels under csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles, on first use, into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the sources and flags, so an edited
source never loads a stale build.  `build_all()` starts one nvcc per source
at once and waits for all of them.  nvcc runs with `-Xptxas=-v`: each
build's log (registers, shared memory and spills of every kernel) is kept
in `BUILD_LOGS`, and `ptxas_usage` reads it.  Nothing here runs at import:
the CPU tests import every module, and a CPU run never builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("context", "span_scatter", "group_rmw", "score", "hot_slice",
                  "quantize", "sweep_scatter")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v"]
# nvcc's output of the builds this process ran, by source name
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA "
                       "toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str, fresh: bool = False):
    """(nvcc process, temp output, final output), or None if built (and
    not `fresh`)."""
    out = _library_path(name)
    if out.exists() and not fresh:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    BUILD_LOGS[name] = log
    os.replace(tmp, out)


def build_all(names=KERNEL_SOURCES, fresh: bool = False) -> Dict[str, Path]:
    """Compile every named source, all nvcc processes running at once
    (`fresh`: even where a build exists, so that BUILD_LOGS has each)."""
    procs: List = [(n, _start_build(n, fresh)) for n in names]
    errors = []
    for n, p in procs:   # wait for every process before raising
        try:
            _finish_build(n, p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _library_path(n) for n in names}


def ptxas_usage(log: str) -> List[dict]:
    """Per kernel of an nvcc `-Xptxas=-v` log: its (mangled) name,
    registers, static shared memory bytes and spill store / load bytes."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            if cur is None or cur["function"] != m.group(1):
                cur = dict(function=m.group(1), registers=None, smem=0,
                           spill_stores=0, spill_loads=0)
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (built now if missing)."""
    _finish_build(name, _start_build(name))
    return ctypes.CDLL(str(_library_path(name)))


def check_launch(fn_name: str, err: int) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with "
                           f"cudaError_t {err}")
