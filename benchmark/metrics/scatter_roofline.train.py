"""K1 (the resampler-backward scatter) against its bytes bound, in %:
the indices and live updates read once and the table written once, a
step, over the device time of its kernel."""

from benchmark.harness import layer

KERNELS = ("scatter_add_rows_kernel",)


def read(run):
    return layer.scatter_roofline(run, KERNELS)
