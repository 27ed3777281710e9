"""Process sharding of one run's input (copy of the host helpers of
dbgtpu/dist/multihost.py: `shard_files`, `shard_ranges`, `shard_path`,
`merge_shards`).

Reads are independent, so processes never exchange read data: each one
maps a contiguous record range of every input file (`shard_ranges`)
against its own copy of the index, built from the same unitig file or
loaded from a persisted one, and writes `<out>.shard<P>`;
`merge_shards` concatenates the shards in process order, which gives the
bytes of a single-process run.  It refuses to merge when a shard is
missing: mapping is stateless per read, so recovery is running the
missing shard again.

A coordinated run (one mesh over the devices of several processes, and
its global statistics) is not part of this module.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple


def shard_files(
    files: Sequence[str], process_id: int, num_processes: int
) -> List[str]:
    """Deterministic round-robin file assignment (file order preserved
    within a host's shard)."""
    return [f for i, f in enumerate(files) if i % num_processes == process_id]


def shard_ranges(
    total: int, num_shards: int
) -> List[Tuple[int, int]]:
    """Split [0, total) into num_shards contiguous [start, end) ranges
    (for record-index sharding of a single large file)."""
    base = total // num_shards
    rem = total % num_shards
    out = []
    start = 0
    for i in range(num_shards):
        n = base + (1 if i < rem else 0)
        out.append((start, start + n))
        start += n
    return out


def shard_path(base: str, process_id: int) -> str:
    return f"{base}.shard{process_id}"


def merge_shards(
    base: str, num_processes: int, remove: bool = True
) -> None:
    """Concatenate `<base>.shard0..N-1` into `<base>` in process order.
    Raises FileNotFoundError if any shard is missing (incomplete run —
    re-stream the missing shard rather than merging silently)."""
    shards = [shard_path(base, i) for i in range(num_processes)]
    for s in shards:
        if not os.path.exists(s):
            raise FileNotFoundError(f"missing output shard: {s}")
    with open(base, "wb") as out:
        for s in shards:
            with open(s, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
    if remove:
        for s in shards:
            os.remove(s)
