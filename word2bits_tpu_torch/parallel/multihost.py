"""Process-group bootstrap and the host-sharded vocabulary pass.

The counterpart of the JAX package's parallel/multihost.py.

  * `initialize()` joins the process group that torchrun describes in the
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK):
    NCCL on the card, each process on cuda:LOCAL_RANK; gloo on the CPU.
    Without that environment it returns False and starts nothing, as the
    JAX initialize does without a coordinator.  `start_local_group()`
    starts a one-rank group on 127.0.0.1 at a free port, for a mesh of one
    shard in a plain process (its collectives are then real calls).
  * corpus work is sharded by host the way the reference shards by thread
    (byte ranges, reference src/word2bits.cpp:377): each host counts its
    range and the counts are summed (`merge_counts`).  The three functions
    are byte-for-byte the JAX package's, on the port's tokenizer
    (data/corpus.split_tokens).

A lost process aborts the step; recovery is a restart from the latest
checkpoint (-checkpoint-dir), as in the JAX package.
"""

from __future__ import annotations

import os
import socket
from collections import Counter
from datetime import timedelta
from typing import Dict, List

import torch
import torch.distributed as dist

from word2bits_tpu_torch.data.corpus import split_tokens

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
_TIMEOUT = timedelta(minutes=30)    # a rank-0 checkpoint write fits inside


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device_type: str) -> torch.device:
    """This process's device: cuda:LOCAL_RANK on the card (made current),
    else the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(dev)
    return dev


def initialize(device_type: str = "cuda") -> bool:
    """Join torchrun's process group (NCCL for device_type 'cuda', gloo
    for 'cpu'); True if this process is in one.  Returns False, starting
    nothing, when torchrun's environment is unset."""
    if dist.is_initialized():
        return True
    if any(k not in os.environ for k in _ENV):
        return False
    rank_device(device_type)
    dist.init_process_group(backend_for(device_type), init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]), timeout=_TIMEOUT)
    return True


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_local_group(device_type: str = "cuda") -> None:
    """A one-rank process group on 127.0.0.1 at a free port (NCCL for
    'cuda', gloo for 'cpu'); the caller destroys it
    (dist.destroy_process_group)."""
    rank_device(device_type)
    dist.init_process_group(backend_for(device_type),
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, timeout=_TIMEOUT)


def host_byte_range(path: str, host_id: int, num_hosts: int):
    """The byte range host `host_id` scans — the reference's per-thread
    fseek sharding (src/word2bits.cpp:377): ranges split evenly; a word
    straddling a boundary is read by the range that holds its start."""
    size = os.path.getsize(path)
    start = size * host_id // num_hosts
    end = size * (host_id + 1) // num_hosts
    return start, end


def count_words_range(path: str, start: int, end: int) -> Dict[str, int]:
    """Frequency-count only [start, end) of the corpus (host-local pass).
    Skips the first partial word unless at 0; reads through the word that
    begins before `end`."""
    seps = (b" ", b"\t", b"\n")

    def _find_sep(buf, lo):
        hits = [i for i in (buf.find(s, lo) for s in seps) if i != -1]
        return min(hits) if hits else -1

    with open(path, "rb") as f:
        f.seek(start)
        data = f.read(end - start + 4096 + 1)
        extra = len(data) - (end - start)

        if start > 0:
            # drop the leading partial word
            i = _find_sep(data, 0)
            if i == -1:
                return {}
            data = data[i:]
        if extra > 0:
            # keep through the end of the word that starts before `end`,
            # reading on past the 4 KB tail until its separator (or EOF),
            # so no fragment of a word is counted
            scan_from = len(data) - extra
            while True:
                cut = _find_sep(data, scan_from)
                if cut != -1:
                    data = data[:cut + 1]
                    break
                more = f.read(1 << 16)
                if not more:
                    # a word running unterminated to EOF: the reference
                    # ReadWord drops it (src/word2bits.cpp:277-279)
                    last = max(data.rfind(s) for s in seps)
                    if last == -1:
                        return {}
                    data = data[:last + 1]
                    break
                scan_from = len(data)
                data = data + more

    # data ends at a separator or at the EOF cut: what the single-host
    # pass counts for this range
    counts = Counter(split_tokens(data))
    return {k.decode("utf-8", errors="surrogateescape"): v
            for k, v in counts.items()}


def merge_counts(per_host: List[Dict[str, int]]) -> Dict[str, int]:
    """Sum per-host count dicts (the all-gather and sum of the vocab
    pass)."""
    out: Dict[str, int] = {}
    for d in per_host:
        for w, c in d.items():
            out[w] = out.get(w, 0) + c
    return out
