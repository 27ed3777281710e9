"""The device index as torch tensors (counterpart of
dbgtpu/engine/core.py IndexArrays / index_to_device).

This module carries the state from the numpy `DeviceIndex` built by
dbgtpu.index.device onto a torch device.  Tables whose JAX dtype is
uint32 are held as int32 tensors with the same bits (torch has little
uint32 support); the kernels read them as uint32 and the plain
versions mask them back to 32-bit values in int64 lanes.

Only the `scan` layouts are ported: the junction scan table and, for
dog mode (-G), the anchor scan table.  An index that needs an MPHF
lookup (the `mphf` junction layout, or MPHF anchors, which dbgtpu takes
for dog keysets of ANCHOR_MPHF_MIN keys or more) is refused with
`UnsupportedIndex`: that lookup is ROADMAP B12, not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dbgtpu.index.device import ANCHOR_MPHF_MIN, PT_SLOTS, DeviceIndex

# umeta column layout (dbgtpu.index.device.build_device_index)
C_UOFF, C_ULEN = 0, 1
C_BEG_HI, C_BEG_LO, C_END_HI, C_END_LO = 2, 3, 4, 5
C_RCB_HI, C_RCB_LO, C_RCE_HI, C_RCE_LO = 6, 7, 8, 9
META_COLS = 16          # metadata columns before the embedded sequence
# read positions per gather in the plain fused-table lookups, so the
# gathered rows stay [B, LOOKUP_CHUNK, row width]
LOOKUP_CHUNK = 8


@dataclass
class IndexTensors:
    st_fused: torch.Tensor   # int32 [nb, 10*S]: S slot key-hi | S key-lo |
    #                          S slots x 8 junction ids (uint32 bits)
    st_seed: int             # bucket-hash seed of st_fused
    umeta: torch.Tensor      # int32 [U+1, 16 + 2*SW]: metadata columns,
    #                          then SW fwd and SW rc packed-sequence words
    pool_rows: torch.Tensor  # int32 [2*n_chunks, RW] fwd then rc chunk
    #                          rows (uint32 bits; 1 placeholder row when
    #                          the sequence is embedded in umeta)
    n_chunks: int            # forward chunk-row count
    pt_rows: torch.Tensor    # int32 [nbp, W*PT_SLOTS] closure-probe rows
    #                          (W = 4 or 3); [0, 32] when absent
    pt_seed: int             # bucket-hash seed of pt_rows
    at_fused: torch.Tensor   # int32 [nba, 5*S] dog anchor table: S slot
    #                          key-hi | S key-lo | S slots x (uid, upos,
    #                          ucanon); [0, 160] when absent
    at_seed: int             # bucket-hash seed of at_fused

    @property
    def st_slots(self) -> int:
        return self.st_fused.shape[1] // 10

    @property
    def at_slots(self) -> int:
        return self.at_fused.shape[1] // 5

    @property
    def seq_words(self) -> int:
        """SW: packed-sequence words per orientation embedded in umeta
        (0 = windows come from pool_rows)."""
        return (self.umeta.shape[1] - META_COLS) // 2

    @property
    def pt_window(self) -> int:
        """Positions answered per closure probe (derived from the row
        width, as in core._closure_member)."""
        return 4 if self.pt_rows.shape[1] == 4 * PT_SLOTS else 3


class UnsupportedIndex(ValueError):
    """The index needs a layout this port does not run yet."""


def fuse_scan_table(t) -> np.ndarray:
    """ScanTable -> fused [nb, 2*S + V*S] uint32 rows: slot keys, then
    each slot's V values (V = 8 junction ids, or 3 anchor values)
    (core._fuse_scan_table, which lives in a module that imports JAX)."""
    nb = t.keys.shape[0]
    return np.concatenate(
        [t.keys, t.vals.reshape(nb, -1).view(np.uint32)], axis=1
    )


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """numpy array -> tensor on `device`; uint32 arrays become int32
    tensors with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def index_tensors(di: DeviceIndex, device) -> IndexTensors:
    """DeviceIndex (numpy) -> IndexTensors on `device`, memoized on `di`
    per device: the index upload is the largest transfer of a run.
    `cuda` and `cuda:<current>` name one card and share one entry."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    memo = getattr(di, "_torch_ix", None)
    if memo is None:
        memo = {}
        di._torch_ix = memo
    key = str(device)
    if key in memo:
        return memo[key]
    if di.mphf_junction is not None or di.scan_tbl is None:
        raise UnsupportedIndex(
            "index layout 'mphf' (MPHF junction lookup, ROADMAP B12) is "
            "not ported; dbgtpu_torch runs the 'scan' layout"
        )
    if di.anchor_mphf is not None:
        raise UnsupportedIndex(
            f"the dog-mode (-G) index holds {len(di.anchor_mphf.arows):,} "
            f"anchors and takes the MPHF anchor layout (at least "
            f"{ANCHOR_MPHF_MIN:,} anchors, or --index-layout mphf); its "
            "MPHF lookup (ROADMAP B12) is not ported"
        )
    t = di.scan_tbl
    pt = di.probe_tbl
    at = di.anchor_scan

    def u32(a):
        return to_device(np.asarray(a, np.uint32), device)

    ix = IndexTensors(
        st_fused=u32(fuse_scan_table(t)),
        st_seed=int(t.seed),
        umeta=to_device(np.asarray(di.umeta, np.int32), device),
        pool_rows=u32(di.pool_rows),
        n_chunks=int(di.n_chunks),
        pt_rows=(u32(pt.rows) if pt is not None
                 else torch.zeros((0, 32), dtype=torch.int32,
                                  device=device)),
        pt_seed=int(pt.seed) if pt is not None else 0,
        at_fused=(u32(fuse_scan_table(at)) if at is not None
                  else torch.zeros((0, 160), dtype=torch.int32,
                                   device=device)),
        at_seed=int(at.seed) if at is not None else 0,
    )
    memo[key] = ix
    return ix
