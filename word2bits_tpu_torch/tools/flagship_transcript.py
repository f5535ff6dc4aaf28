"""The transcript writer of the port's flagship tools (flagship_run.py,
flagship_complete.py), modelled on the JAX package's
tools/flagship_transcript.py, which stays as it is.

One writer for both tools, so the title rule lives in one place: the
title says "Flagship" only at the flagship scale (at least 3M words and
50M tokens) and "Smoke" otherwise.  The caller gives the path; the JAX
package's transcripts under docs/ are refused.  The markdown names the
device the run used (a card by the name and power limit nvidia-smi gives)
and holds the transcript as one JSON block.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FLAGSHIP_VOCAB = 3_000_000
FLAGSHIP_TOKENS = 50_000_000
# the JAX package's flagship transcripts: the reference, never overwritten
JAX_TRANSCRIPTS = tuple(
    os.path.join(REPO, "docs", f"flagship_r{r}_transcript.md")
    for r in (4, 5))

_BODY = ("a text corpus parsed by the native tokenizer, streamed "
         "multi-segment multi-epoch training on a bf16 fused table "
         "(-scatter-impl grmw -loop-mode fori, or --rmw), a full-state "
         "checkpoint and a resumed epoch, the reference-format binary and "
         "packed export, and the analogy evaluation over every row (the "
         "cross-check against the reference's compute-accuracy waits for "
         "its source in this repository).")


def card_name(device: str) -> str:
    """The device as the transcript names it: on a card, its name and
    power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them."""
    if not device.startswith("cuda"):
        return f"{device} (no card)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def write_transcript(transcript: dict, path: str, n_tokens: int,
                     n_vocab: int, size: int, producer: str,
                     provenance: str = "") -> str:
    """Write the run's transcript (markdown plus its JSON block) to
    `path`; returns the path.  `transcript["device"]["card"]` names the
    device; `provenance` is an optional paragraph."""
    path = os.path.realpath(path)
    if path in {os.path.realpath(j) for j in JAX_TRANSCRIPTS}:
        raise ValueError(f"{path} is a JAX package transcript; pick another "
                         "path")
    card = transcript.get("device", {}).get("card", "not recorded")
    if n_vocab >= FLAGSHIP_VOCAB and n_tokens >= FLAGSHIP_TOKENS:
        title = (f"# Flagship end-to-end run of the port ({n_vocab / 1e6:.1f}M"
                 f" x {size}d, 1-bit, {card})\n\n"
                 "The full production path at the reference's headline "
                 "scale (reference README.md:39): ")
    else:
        title = (f"# Smoke run of the port's flagship path ({n_vocab:,} "
                 f"words x {size}d on {n_tokens:,} tokens, {card}; not the "
                 "flagship scale)\n\nA reduced-scale exercise of the "
                 "flagship path: ")
    prov = ("\n" + provenance.strip() + "\n") if provenance else ""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(title + _BODY + f"  Produced by {producer}.\n" + prov
                + "\n```json\n" + json.dumps(transcript, indent=2)
                + "\n```\n\n"
                f"Generated {time.strftime('%Y-%m-%d %H:%M')}.\n")
    return path
