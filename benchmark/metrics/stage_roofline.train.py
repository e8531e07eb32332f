"""K2 and K3 (the fused U-Net stages) against their roofline, in %: the
least time of the stages the slice launched, from the configuration's
shapes and the launch counters, over the device time of these kernels."""

from benchmark.harness import layer

KERNELS = ("contract_kernel", "contract_split_kernel", "expand_kernel",
           "expand_split_kernel")


def read(run):
    return layer.stage_roofline(run, "train", KERNELS)
