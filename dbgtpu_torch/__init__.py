"""dbgtpu_torch — the PyTorch and CUDA port of dbgtpu for one NVIDIA
Hopper GPU (sm_90a).

Read mapping against the `scan` and `mphf` index layouts in all three of
dbgtpu's device modes: greedy, anchor (dog, -G) and exhaustive (-b, with
-i).  The device stages of dbgtpu's align_batches_packed_compact (read
scan, junction membership, greedy junction walk, path packing, the dog
anchor lookup and placement, the exhaustive DFS, the MPHF lookup, the
compact result layout) are eight hand-written CUDA kernels in `csrc/`,
built with nvcc at first use and bound with ctypes (`kernels/build.py`);
four more (`csrc/gather.cu`) are the gather experiments that
`tools/exp_gather.py` runs.
Every kernel has a plain torch version beside it, which the wrappers use
for CPU tensors only.  Graph build, read parsing, output formatting and
the executable spec are this package's own copies of dbgtpu's host
modules: it imports torch, numpy and the standard library, never JAX and
never dbgtpu.  Module names mirror dbgtpu's.
"""

__version__ = "0.1.0"
