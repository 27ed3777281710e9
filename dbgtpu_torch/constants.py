"""Global constants of the mapper.

Defaults mirror the reference CLI (reference bgreat.cpp:54-66):
k=30, mismatches=2, effort(tryNumber)=2, paths file "paths",
notAligned file "notAligned.fa".
"""

# 2-bit base codes. A=0, C=1, G=2, everything else (T, N, junk) = 3,
# matching reference str2num (utils.cpp:117-129).
A, C, G, T = 0, 1, 2, 3

DEFAULT_K = 30
DEFAULT_MISMATCHES = 2
DEFAULT_EFFORT = 2  # reference `tryNumber`
DEFAULT_PATHS_FILE = "paths"
DEFAULT_NOT_ALIGNED_FILE = "notAligned.fa"

# Maximum supported k: kmers are uint64 (2 bits/base), reference
# utils.h:27 has the same cap.
MAX_K = 32

# Per-read alignment outcome codes (engine + model share these).
STATUS_PENDING = 0
STATUS_ALIGNED_FWD = 1
STATUS_ALIGNED_RC = 2
STATUS_NO_OVERLAP_FWD = 3   # forward read had no anchors at all
STATUS_RC_NO_OVERLAP = 4    # fwd anchors failed; RC read had no anchors
STATUS_FAILED = 5           # anchors existed (fwd, then RC) but no alignment
