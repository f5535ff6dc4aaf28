"""The port's `cli convert` and `cli nearest` == the JAX package's (CPU).

With W2B_FORCE_CPU=1 the port's commands run on the CPU (kernel 4's plain
version).  Every case of tests/test_convert.py and tests/test_nearest.py
goes through both packages: the files they write are byte-identical, the
return codes equal, the printed lines equal (the output path aside), and
the nearest transcripts equal apart from the order of neighbours whose
similarities tie within 1e-6 (float32 sums in another order) and the
sixth decimal of a similarity (1e-6).
"""

import gzip
import sys

import numpy as np
import pytest

from word2bits_tpu import cli as jcli
from word2bits_tpu.io.vectors import write_vectors
from word2bits_tpu_torch import cli as tcli


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("W2B_FORCE_CPU", "1")


def _write_fp32(path, rng, V=7, D=12, binary=True):
    words = [f"w{i}" for i in range(V)]
    vecs = rng.uniform(-1.2, 1.2, (V, D)).astype(np.float32)
    write_vectors(str(path), words, vecs, binary=binary)
    return words, vecs


def _both(tmp_path, capsys, fn_name, src_args, flags, out_name):
    """Run the JAX and the port's command on the same inputs, each into
    its own output file; returns ((rc, stdout, bytes) JAX, port)."""
    outs = []
    for tag, mod in (("jax", jcli), ("port", tcli)):
        dst = tmp_path / f"{tag}_{out_name}"
        rc = getattr(mod, fn_name)([*src_args, str(dst), *flags])
        out = capsys.readouterr().out.replace(str(dst), "DST")
        data = dst.read_bytes() if dst.exists() else None
        outs.append((rc, out, data))
    return outs


@pytest.mark.parametrize("name,V,D,binary,flags,out", [
    # tests/test_convert.py cases
    ("requantize_binary", 7, 12, True, ["-bitlevel", "1", "-binary", "1"],
     "out.bin"),
    ("fp32_to_packed", 7, 17, True, ["-bitlevel", "2", "-packed", "1"],
     "out.pack"),
    ("threshold_truncates", 9, 12, True, ["-threshold", "4", "-binary", "1"],
     "out.bin"),
    ("packed_rejects_fp32_grid", 7, 12, True, ["-packed", "1"], "out.pack"),
    # and the other formats and bitlevels
    ("text_source_bitlevel4_text", 11, 5, False, ["-bitlevel", "4"],
     "out.txt"),
    ("bitlevel8_binary_threshold", 30, 9, True,
     ["-bitlevel", "8", "-binary", "1", "-threshold", "25"], "out.bin"),
    ("bitlevel1_packed_threshold", 30, 9, True,
     ["-bitlevel", "1", "-packed", "1", "-threshold", "13"], "out.pack"),
])
def test_convert_equals_jax(tmp_path, rng, capsys, name, V, D, binary, flags,
                            out):
    src = tmp_path / "in.bin"
    _write_fp32(src, rng, V=V, D=D, binary=binary)
    (jrc, jout, jdata), (trc, tout, tdata) = _both(
        tmp_path, capsys, "convert_main", [str(src)], flags, out)
    assert (trc, tout) == (jrc, jout)
    assert tdata == jdata
    if name == "packed_rejects_fp32_grid":
        assert trc == 1 and tdata is None


@pytest.mark.parametrize("flags", [[], ["-bitlevel", "2"],
                                   ["-threshold", "5", "-binary", "1"]])
def test_convert_packed_source_equals_jax(tmp_path, rng, capsys, flags):
    """tests/test_convert.py's packed_to_text, and a .pack re-quantized and
    truncated: the port reads the .pack in row blocks."""
    src, mid = tmp_path / "in.bin", tmp_path / "mid.pack"
    _write_fp32(src, rng, V=9)
    assert jcli.convert_main([str(src), str(mid), "-bitlevel", "1",
                              "-packed", "1"]) == 0
    capsys.readouterr()
    (jrc, jout, jdata), (trc, tout, tdata) = _both(
        tmp_path, capsys, "convert_main", [str(mid)], flags, "out")
    assert (trc, tout, tdata) == (jrc, jout, jdata) and trc == 0


def test_convert_gzip_text_source(tmp_path, rng, capsys):
    src = tmp_path / "in.txt"
    _write_fp32(src, rng, V=6, D=4, binary=False)
    gz = tmp_path / "in.txt.gz"
    gz.write_bytes(gzip.compress(src.read_bytes()))
    (jrc, jout, jdata), (trc, tout, tdata) = _both(
        tmp_path, capsys, "convert_main", [str(gz)],
        ["-bitlevel", "2", "-binary", "1"], "out.bin")
    assert (trc, tout, tdata) == (jrc, jout, jdata) and trc == 0


@pytest.mark.parametrize("argv", [[], ["only_one"], ["a", "b", "-bitlevel"]])
def test_convert_usage_and_errors(capsys, argv):
    rcs = []
    for mod in (jcli, tcli):
        rcs.append((mod.convert_main(list(argv)), capsys.readouterr()))
    (jrc, jcap), (trc, tcap) = rcs
    assert trc == jrc and tcap.out == jcap.out and tcap.err == jcap.err


def _parse(transcript: str):
    """[(query line, [(word, similarity)])] of a nearest transcript."""
    out = []
    for line in transcript.splitlines():
        if line.startswith("  "):
            w, s = line.split()
            out[-1][1].append((w, float(s)))
        else:
            out.append((line, []))
    return out


def assert_same_neighbours(got: str, want: str, tie: float = 1e-6):
    """Equal transcripts apart from the order of neighbours whose
    similarities tie within `tie` and the last printed digit."""
    g, w = _parse(got), _parse(want)
    assert [q for q, _ in g] == [q for q, _ in w]
    for (q, gn), (_, wn) in zip(g, w):
        assert len(gn) == len(wn), q
        np.testing.assert_allclose([s for _, s in gn], [s for _, s in wn],
                                   atol=1.5e-6, rtol=0)
        for i, ((gw, gs), (ww, _)) in enumerate(zip(gn, wn)):
            if gw != ww:
                # the port's word sits among the JAX list's ties
                near = [x for x, s in wn if abs(s - gs) <= tie + 1.5e-6]
                assert gw in near or i >= len(wn) - len(near), (q, gw, ww)


def _toy_file(tmp_path):
    words = ["</s>", "cat", "dog", "rock"]
    vecs = np.array([[0.0, 0.0, 1.0],
                     [1.0, 0.1, 0.0],
                     [1.0, 0.0, 0.0],
                     [0.0, 1.0, 0.0]], np.float32)
    p = tmp_path / "v.bin"
    write_vectors(str(p), words, vecs, binary=True)
    return p


def _nearest_both(capsys, argv):
    outs = []
    for mod in (jcli, tcli):
        rc = mod.nearest_main(list(argv))
        outs.append((rc, capsys.readouterr().out))
    return outs


@pytest.mark.parametrize("words", [["cat", "-topk", "2"],
                                   ["CAT", "zebra"]])
def test_nearest_equals_jax(tmp_path, capsys, words):
    """tests/test_nearest.py's ranks_by_cosine and case_insensitive_and_oov
    cases."""
    p = _toy_file(tmp_path)
    (jrc, jout), (trc, tout) = _nearest_both(capsys, [str(p), *words])
    assert trc == jrc == 0
    assert_same_neighbours(tout, jout)


def test_nearest_requantize_equals_jax(tmp_path, capsys):
    words = ["cat", "dog", "rock"]
    vecs = np.array([[1.0, 0.1, 0.0],
                     [0.5, 0.2, 0.3],
                     [0.9, -0.5, 0.1]], np.float32)
    p = tmp_path / "q.bin"
    write_vectors(str(p), words, vecs, binary=True)
    (jrc, jout), (trc, tout) = _nearest_both(
        capsys, [str(p), "cat", "-bitlevel", "1", "-topk", "2"])
    assert trc == jrc == 0
    assert_same_neighbours(tout, jout)
    assert tout.splitlines()[1].split()[0] == "dog"


@pytest.mark.parametrize("bitlevel", ["0", "1", "4"])
def test_nearest_many_words_and_stdin(tmp_path, rng, capsys, monkeypatch,
                                      bitlevel):
    """200 x 16 vectors (at bitlevel 1 many similarities tie), ten queries
    given as words and the same read from stdin up to EXIT."""
    words, _ = _write_fp32(tmp_path / "v.bin", rng, V=200, D=16)
    qs = [words[i] for i in rng.integers(0, 200, 10)] + ["nosuchword"]
    argv = [str(tmp_path / "v.bin"), *qs, "-bitlevel", bitlevel, "-topk",
            "7"]
    (jrc, jout), (trc, tout) = _nearest_both(capsys, argv)
    assert trc == jrc == 0
    assert_same_neighbours(tout, jout)
    import io
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(qs) + "\nEXIT\n"
                                                  "w1\n"))
    assert tcli.nearest_main([str(tmp_path / "v.bin"), "-bitlevel", bitlevel,
                              "-topk", "7"]) == 0
    assert_same_neighbours(capsys.readouterr().out, jout)


def test_nearest_usage(capsys):
    (jrc, jout), (trc, tout) = _nearest_both(capsys, [])
    assert (trc, tout) == (jrc, jout) == (0, jout)


def test_main_dispatches_convert_and_nearest(tmp_path, rng, capsys,
                                             monkeypatch):
    src = tmp_path / "in.bin"
    _write_fp32(src, rng)
    monkeypatch.setattr(sys, "argv", ["cli", "convert", str(src),
                                      str(tmp_path / "o.pack"), "-bitlevel",
                                      "1", "-packed", "1"])
    assert tcli.main() == 0
    monkeypatch.setattr(sys, "argv", ["cli", "nearest", str(tmp_path /
                                                             "o.pack"),
                                      "w1", "-topk", "3"])
    assert tcli.main() == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("7 x 12 -> ") and out[1] == "w1:"
    assert len(out) == 5


def test_convert_and_nearest_default_to_the_card(tmp_path, rng, monkeypatch):
    """Without W2B_FORCE_CPU=1 both commands run on the card; without one
    they raise instead of dropping to the CPU, and write nothing."""
    src = tmp_path / "in.bin"
    _write_fp32(src, rng)
    monkeypatch.delenv("W2B_FORCE_CPU")
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="W2B_FORCE_CPU"):
        tcli.convert_main([str(src), str(tmp_path / "o.bin"), "-bitlevel",
                           "1"])
    assert not (tmp_path / "o.bin").exists()
    with pytest.raises(RuntimeError, match="W2B_FORCE_CPU"):
        tcli.nearest_main([str(src), "w1"])
