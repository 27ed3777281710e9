"""Σ of the batches' kernel bounds (roofline.py, counted from shapes)
over Σ device time of the mapping kernels in the window, in percent."""


def read(run):
    s = run.mapping_kernel_s()
    return 100.0 * run.bound_s() / s if s else None
