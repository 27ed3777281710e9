"""Device milliseconds of the mapping kernels (K1 read_scan, K2 member,
K3 greedy_walk, K4 pack_paths, K8 compact_result, by name in the
window's trace, all cards) per batch."""


def read(run):
    s, n = run.mapping_kernel_s(), run.batches()
    return s / n * 1e3 if s and n else None
