"""Data parallelism over the read batch on local devices (counterpart of
dbgtpu/dist/mesh.py make_mesh and the mesh branch of dbgtpu's
align_bulk).

Mapping is independent per read, so a mesh shards each batch's reads
over its devices in contiguous equal shards and replicates the
read-only index on every one (engine/runner.py align_bulk with
`mesh=`).  dbgtpu also sums a status histogram across the mesh with a
psum, which its runner discards (runner.py:315); the counts come from
the rows here too, so the replicated mesh needs no collective.  A
sharded index (`--shard-index` over more than one device, dbgtpu's
core.py _sharded_rows) is not part of this module.

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
