"""ctypes bindings for the native tokenizer (native/tokenizer.cpp, a copy of
the JAX package's source).

The C++ library counts and encodes a corpus with the reference ReadWord
semantics, builds the Walker alias table, and fills the reference LCG init
stream, each bit for bit what the pure-Python paths compute
(data/corpus.count_words and encode_corpus, sampling/unigram.
build_alias_table, utils/lcg.lcg_uniform_block), which stay as the
fallback.  It is built with g++ at first use (never at import) into
word2bits_tpu_torch/_build/, under a name that carries a hash of the
source and flags, as kernels/_build.py builds the CUDA kernels:

    g++ -O3 -shared -fPIC -std=c++17 -pthread -o _build/libw2btok-<hash>.so \\
        native/tokenizer.cpp

`load()` returns the library or raises with the compiler's message;
`library()` returns it or None (the callers' `use_native=None`: fall back
to Python); `use_native=True` at the callers raises instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "tokenizer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_cache: Dict[str, object] = {}


class NativeLib:
    """The library's four entry points; each returns None when the C call
    reports a failure (a file it cannot open, a bad argument)."""

    def __init__(self, cdll: ctypes.CDLL):
        self._lib = cdll
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        for name, args in (
                ("w2b_count_words", [ctypes.c_char_p, ctypes.c_char_p]),
                ("w2b_encode", [ctypes.c_char_p] * 3),
                ("w2b_alias_build", [f64, f64, i64, ctypes.c_int64]),
                ("w2b_lcg_fill", [ctypes.c_int64] * 3 + [f32])):
            fn = getattr(cdll, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = args

    def count_words(self, path: str) -> Optional[Dict[str, int]]:
        """{word: count} of the corpus, `</s>` included."""
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "counts")
            if self._lib.w2b_count_words(os.fsencode(path),
                                         os.fsencode(out)) < 0:
                return None
            counts: Dict[str, int] = {}
            with open(out, "r", encoding="utf-8",
                      errors="surrogateescape") as f:
                for line in f:
                    sp = line.rsplit(" ", 1)
                    if len(sp) == 2:
                        counts[sp[0]] = int(sp[1])
            return counts

    def encode_corpus(self, path: str,
                      words: List[str]) -> Optional[np.ndarray]:
        """int32 ids of the corpus under `words` (OOV dropped)."""
        with tempfile.TemporaryDirectory() as d:
            vocab, out = os.path.join(d, "vocab"), os.path.join(d, "ids")
            with open(vocab, "w", encoding="utf-8",
                      errors="surrogateescape") as f:
                f.write("\n".join(words) + "\n")
            n = self._lib.w2b_encode(os.fsencode(path), os.fsencode(vocab),
                                     os.fsencode(out))
            if n < 0:
                return None
            return np.fromfile(out, dtype="<i4", count=n)

    def alias_build(self, scaled: np.ndarray):
        """(prob float64 [V], alias int64 [V]) of the Walker construction
        from mean-1 weights; `scaled` is a fresh float64 copy (mutated)."""
        V = scaled.shape[0]
        prob = np.empty(V, np.float64)
        alias = np.empty(V, np.int64)
        rc = self._lib.w2b_alias_build(scaled, prob, alias, V)
        return (prob, alias) if rc == V else None

    def lcg_fill(self, start_draw: int, n: int,
                 seed: int = 1) -> Optional[np.ndarray]:
        """Draws [start_draw, start_draw + n) of the reference init
        stream as float32."""
        out = np.empty(n, np.float32)
        rc = self._lib.w2b_lcg_fill(start_draw, n, seed, out)
        return out if rc == n else None


def library_path(src: Path = SRC) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"libw2btok-{h.hexdigest()[:12]}.so"


def build(src: Optional[Path] = None, fresh: bool = False) -> Path:
    """Compile src (default SRC) into _build/ (a temporary name, then
    renamed) unless that build exists and not `fresh`; raise RuntimeError
    with the compiler's output."""
    src = SRC if src is None else src
    if not src.exists():
        raise RuntimeError(f"native tokenizer source {src} is missing")
    out = library_path(src)
    if out.exists() and not fresh:
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native tokenizer builds "
                           "with g++ (or $CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {src.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> NativeLib:
    """The library, built now if missing; raises RuntimeError when it
    cannot be built or loaded (the failure is remembered)."""
    key = str(SRC)
    got = _cache.get(key)
    if got is None:
        try:
            got = NativeLib(ctypes.CDLL(str(build(SRC))))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            got = RuntimeError(f"native tokenizer unavailable: {e}")
        _cache[key] = got
    if isinstance(got, Exception):
        raise got
    return got


def library() -> Optional[NativeLib]:
    """The library, or None when it cannot be built."""
    try:
        return load()
    except RuntimeError:
        return None


def native_for(use_native: Optional[bool]) -> Optional[NativeLib]:
    """The library a caller's `use_native` asks for: None for False, the
    library or None (fall back) for None, the library or an error for
    True."""
    if use_native is False:
        return None
    return load() if use_native else library()
