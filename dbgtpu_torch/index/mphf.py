"""Minimal perfect hash function (BBHash algorithm): host build, host
lookup, save/load.  Copy of the host part of dbgtpu/index/mphf.py; the
device lookup is K7 (csrc/mphf.cuh, engine/mphf.py).

The reference embeds BooPHF (BooPHF.h, 1217 LoC): a cascade of
collision-free bit arrays — keys colliding at level i retry at level
i+1; survivors after the last level land in a plain exact map.  Lookup
is bit-test + rank.  This module reimplements that *algorithm* from its
description with a layout designed for device lookup:

  - host construction is vectorized numpy (bincount collision detection
    per level), not per-key loops,
  - level sizes are powers of two so device range-reduction is a mask
    (the reference uses `% size`; only the mapping changes, which is
    semantics-free — MPHF output always feeds key-verified tables),
  - all level bitvectors are concatenated into ONE uint32 word array
    with per-level offsets; ranks are sampled every 4 words (128 bits)
    so a device rank is one sample load + <=4 popcounts,
  - the final level is an exact open-addressing table (same defense as
    the reference's std::unordered_map fallback, BooPHF.h:794-809),
  - save/load to npz: the reference HAS BooPHF save/load but never calls
    it (SURVEY.md §5 checkpoint note).

Contract (matches BooPHF's): keys in the build set map to distinct
slots in [0, n); keys NOT in the build set may alias any slot or return
NOT_FOUND — callers must verify via stored keys/values, exactly as the
reference does (aligner.cpp:158-169).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .hash32 import mix32, mix32b, split64
from .device import HashTable, build_hash_table, ht_find_host

NOT_FOUND = np.int64(-1)

_RANK_STRIDE = 4  # words per rank sample (128 bits)

# level seeds: fixed, deterministic (splitmix-style sequence)
_SEEDS_HI = np.array(
    [(0x9E3779B97F4A7C15 * (i + 1) >> 32) & 0xFFFFFFFF for i in range(64)],
    dtype=np.uint32,
)
_SEEDS_LO = np.array(
    [(0xBF58476D1CE4E5B9 * (i + 1)) & 0xFFFFFFFF for i in range(64)],
    dtype=np.uint32,
)


def _level_hash(hi, lo, lvl: int):
    """uint32 position hash for level lvl."""
    return mix32(hi ^ _SEEDS_HI[lvl], lo ^ _SEEDS_LO[lvl])


if hasattr(np, "bitwise_count"):
    def _popcount32(words: np.ndarray) -> np.ndarray:
        return np.bitwise_count(words).astype(np.int32)
else:  # pragma: no cover - numpy < 2.0 fallback
    _PC16 = np.array(
        [bin(i).count("1") for i in range(1 << 16)], dtype=np.int32
    )

    def _popcount32(words: np.ndarray) -> np.ndarray:
        w = np.asarray(words, np.uint32)
        return _PC16[w & 0xFFFF] + _PC16[w >> 16]


@dataclass
class MPHF:
    """Host-side MPHF; engine.index.fuse_mphf lays it out for K7."""

    n_keys: int
    gamma: float
    n_levels: int                 # levels actually used
    words: np.ndarray             # uint32, all levels concatenated
    word_off: np.ndarray          # int32 [n_levels+1]
    mask: np.ndarray              # uint32 [n_levels] (level nbits - 1)
    rank_base: np.ndarray         # int64 [n_levels] slots before level
    samples: np.ndarray           # int32, rank samples, concatenated
    sample_off: np.ndarray        # int32 [n_levels+1]
    final_tbl: HashTable | None   # survivors -> slot (exact table)

    # ---------- host lookup ----------
    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized slot lookup.  int64 [N]; NOT_FOUND for keys that
        miss every level and the final table."""
        keys = np.asarray(keys, dtype=np.uint64)
        hi, lo = split64(keys)
        res = np.full(len(keys), NOT_FOUND, dtype=np.int64)
        for lvl in range(self.n_levels):
            pos = (_level_hash(hi, lo, lvl) & self.mask[lvl]).astype(np.int64)
            w = pos >> 5
            bit = (self.words[self.word_off[lvl] + w] >> (pos & 31)) & 1
            hit = (res == NOT_FOUND) & (bit == 1)
            if not hit.any():
                continue
            rank = self._rank(lvl, pos[hit])
            res[hit] = rank
        if self.final_tbl is not None:
            pending = res == NOT_FOUND
            if pending.any():
                slots = ht_find_host(
                    self.final_tbl, hi[pending], lo[pending]
                )
                flat = self.final_tbl.vals.reshape(-1)
                vals = np.where(
                    slots >= 0,
                    flat[np.maximum(slots, 0)].astype(np.int64),
                    NOT_FOUND,
                )
                res[pending] = vals
        return res

    def _rank(self, lvl: int, pos: np.ndarray) -> np.ndarray:
        w = pos >> 5
        base = int(self.rank_base[lvl])
        s = self.samples[self.sample_off[lvl] + (w >> 2).astype(np.int64)]
        out = base + s.astype(np.int64)
        w0 = (w >> 2) << 2
        for j in range(_RANK_STRIDE):
            wj = w0 + j
            full = wj < w
            partial = wj == w
            word = self.words[self.word_off[lvl] + np.minimum(wj, w)]
            pc_full = _popcount32(word)
            below = np.uint32(1) << (pos & 31).astype(np.uint32)
            pc_part = _popcount32(word & (below - np.uint32(1)))
            out += np.where(full, pc_full, 0) + np.where(partial, pc_part, 0)
        return out

    # ---------- persistence ----------
    def save(self, path: str) -> None:
        d = dict(
            n_keys=self.n_keys, gamma=self.gamma, n_levels=self.n_levels,
            words=self.words, word_off=self.word_off, mask=self.mask,
            rank_base=self.rank_base, samples=self.samples,
            sample_off=self.sample_off,
        )
        if self.final_tbl is not None:
            t = self.final_tbl
            d.update(f_khi=t.khi, f_klo=t.klo, f_vals=t.vals)
        np.savez_compressed(path, **d)

    @classmethod
    def load(cls, path: str) -> "MPHF":
        z = np.load(path)
        final = None
        if "f_khi" in z:
            final = HashTable(
                z["f_khi"], z["f_klo"], z["f_vals"], z["f_khi"].shape[0]
            )
        return cls(
            n_keys=int(z["n_keys"]), gamma=float(z["gamma"]),
            n_levels=int(z["n_levels"]), words=z["words"],
            word_off=z["word_off"], mask=z["mask"],
            rank_base=z["rank_base"], samples=z["samples"],
            sample_off=z["sample_off"], final_tbl=final,
        )

    def total_bits(self) -> int:
        """Memory report (cf. BooPHF totalBitSize, BooPHF.h:825-842)."""
        bits = int(self.words.size) * 32 + int(self.samples.size) * 32
        if self.final_tbl is not None:
            t = self.final_tbl
            bits += t.size * (32 + 32 + 32 * t.vals.shape[-1])
        return bits


def build_mphf(
    keys: np.ndarray, gamma: float = 2.0, max_levels: int = 25
) -> MPHF:
    """Build over distinct uint64 keys.  gamma mirrors the reference's
    gammaFactor (aligner.h:94 uses 10 for speed; 2 is the BBHash
    space-lean default) — level sizes round up to powers of two."""
    keys = np.asarray(keys, dtype=np.uint64)
    n = len(keys)
    if n and gamma * n > 2**31:
        raise ValueError("keyset too large for 32-bit level addressing")
    remaining = keys
    words_parts: list[np.ndarray] = []
    samples_parts: list[np.ndarray] = []
    word_off = [0]
    sample_off = [0]
    masks: list[int] = []
    rank_base: list[int] = []
    base = 0
    for lvl in range(max_levels):
        if len(remaining) == 0:
            break
        nbits = 64
        while nbits < gamma * len(remaining):
            nbits <<= 1
        hi, lo = split64(remaining)
        pos = (_level_hash(hi, lo, lvl) & np.uint32(nbits - 1)).astype(np.int64)
        counts = np.bincount(pos, minlength=nbits)
        placed = counts[pos] == 1
        w = np.zeros(nbits >> 5, dtype=np.uint32)
        pp = pos[placed]
        np.bitwise_or.at(w, pp >> 5, np.uint32(1) << (pp & 31).astype(np.uint32))
        pc = _popcount32(w)
        # rank samples: set bits in words[: 4*i] of this level
        n_samples = (len(w) + _RANK_STRIDE - 1) // _RANK_STRIDE
        cum = np.zeros(n_samples, dtype=np.int32)
        if n_samples > 1:
            block = np.add.reduceat(
                pc, np.arange(0, len(w), _RANK_STRIDE)
            )
            cum[1:] = np.cumsum(block[:-1], dtype=np.int64)[: n_samples - 1]
        words_parts.append(w)
        samples_parts.append(cum)
        word_off.append(word_off[-1] + len(w))
        sample_off.append(sample_off[-1] + n_samples)
        masks.append(nbits - 1)
        rank_base.append(base)
        base += int(placed.sum())
        remaining = remaining[~placed]

    final_tbl = None
    if len(remaining):
        fvals = (base + np.arange(len(remaining))).astype(np.int32)
        final_tbl = build_hash_table(remaining, fvals[:, None])

    return MPHF(
        n_keys=n,
        gamma=gamma,
        n_levels=len(masks),
        words=(
            np.concatenate(words_parts) if words_parts
            else np.zeros(0, np.uint32)
        ),
        word_off=np.array(word_off, dtype=np.int32),
        mask=np.array(masks, dtype=np.uint32),
        rank_base=np.array(rank_base, dtype=np.int64),
        samples=(
            np.concatenate(samples_parts) if samples_parts
            else np.zeros(0, np.int32)
        ),
        sample_off=np.array(sample_off, dtype=np.int32),
        final_tbl=final_tbl,
    )
