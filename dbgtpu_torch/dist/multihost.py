"""Process sharding of one run's input and the coordinated run (copy of
the host helpers of dbgtpu/dist/multihost.py: `shard_files`,
`shard_ranges`, `shard_path`, `merge_shards`; and its `init_distributed`
and `global_stats_sum` on torch.distributed).

Reads are independent, so processes never exchange read data: each one
maps a contiguous record range of every input file (`shard_ranges`)
against its own copy of the index, built from the same unitig file or
loaded from a persisted one, and writes `<out>.shard<P>`;
`merge_shards` concatenates the shards in process order, which gives the
bytes of a single-process run.  It refuses to merge when a shard is
missing: mapping is stateless per read, so recovery is running the
missing shard again.

A coordinated run (`--coordinator HOST:PORT` with `--num-processes` > 1)
joins the processes into one torch.distributed group over TCP
(`init_distributed`), with dbgtpu's environment fallbacks, and sums the
four stats counters across it (`global_stats_sum`, an all-reduce on the
gloo backend: the counters are host int64, so no NCCL is needed and
processes may share a card).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """torch.distributed.init_process_group (gloo, tcp://HOST:PORT) with
    dbgtpu's environment fallbacks (JAX_COORDINATOR, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID), so a launcher that drives dbgtpu drives the port.
    Whether a group is up: False without a coordinator; a no-op if one
    is already initialized."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR"
    )
    if coordinator_address is None:
        return False
    if dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    return True


def global_stats_sum(local):
    """Sum a per-process int64 stats vector across every process of the
    torch.distributed group (the reference's shared-memory atomic
    counters, aligner.h:68): one all-reduce.  Identity when
    single-process."""
    import numpy as np
    import torch
    import torch.distributed as dist

    local = np.asarray(local, np.int64)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local
    t = torch.from_numpy(local.copy())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


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
