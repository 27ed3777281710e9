"""Build, load and launch-count of the CUDA kernels."""
