"""Data parallelism over the read batch on local devices (counterpart of
dbgtpu/dist/mesh.py make_mesh and the mesh branch of dbgtpu's
align_bulk).

Mapping is independent per read, so a mesh shards each batch's reads
over its devices in contiguous equal shards and replicates the
read-only index on every one (engine/runner.py align_bulk with
`mesh=`).  dbgtpu also sums a status histogram across the mesh with a
psum, which its runner discards (runner.py:315); the counts come from
the rows here too, so the mesh needs no collective.

With `--shard-index` over D > 1 devices the junction scan table and the
closure-probe table are cut into D bucket ranges instead, one on each
device (engine/index.py sharded_index_tensors; dbgtpu's
dist/mesh.py:152-159), and the rest stays replicated.  dbgtpu answers
the lookups into them with a collective (core.py _sharded_rows:
all_gather of the bucket ids, psum_scatter of the rows) between the
lockstep steps of its walk.  Here each card reads the other cards'
ranges from inside K2 and K3 through peer pointers over NVLink
(csrc/common.cuh scan_row; csrc/shard.cu, K13, says why), so neither of
dbgtpu's psums beside it needs a counterpart: nothing runs in lockstep,
so the walk's liveness psum (core.py:1356-1371) has nothing to agree
on; the has-N psum (core.py:970-981) only makes every shard take the
same branch of a scan whose two branches give the same bytes; and the
status histogram's psum is discarded.  `check_peers` refuses a mesh
with a pair of cards that cannot reach each other: a sharded index is
never quietly replicated.

On a card the mesh is the first N local CUDA devices.  On the CPU, where
torch has one device, a mesh of N is N shards of each batch mapped one
after another by the plain versions of the kernels: the counterpart of
the virtual host devices dbgtpu's tests shard over.
"""

from __future__ import annotations

import torch


def make_mesh(n_devices: int | None = None, device="cuda"
              ) -> list[torch.device]:
    """The devices of a mesh of `n_devices` (None: all) of `device`'s
    kind: the first n local CUDA devices, or fewer where fewer are
    present (as dbgtpu's make_mesh slices jax.local_devices()); on the
    CPU, n shards of the one CPU device (None: one)."""
    device = torch.device(device)
    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        return devices if n_devices is None else devices[:n_devices]
    return [device] * (1 if n_devices is None else n_devices)


def mesh_of(mesh_devices: int, device) -> list[torch.device] | None:
    """dbgtpu's `--mesh` value -> the mesh: None for 0 (no mesh), all
    local devices for a negative value, else the first `mesh_devices`."""
    if not mesh_devices:
        return None
    return make_mesh(None if mesh_devices < 0 else mesh_devices, device)


def check_peers(devices: list[torch.device]) -> None:
    """Raise naming the first ordered pair of the CUDA `devices` where one
    card cannot read the other's memory (peer access), which a sharded
    index needs."""
    for a in devices:
        for b in devices:
            if a != b and not torch.cuda.can_device_access_peer(a.index,
                                                                b.index):
                raise ValueError(
                    f"--shard-index: {a} cannot read the memory of {b} "
                    "(no peer access between the pair), so the index "
                    "cannot be sharded over this mesh")
