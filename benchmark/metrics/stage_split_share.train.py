"""K2 and K3 by route, in %: the share of the fused stages' device time in
the traced slice that runs in the split kernels, out of the four kernels
stage_roofline.train reads. A stage shape without a measured split plan
runs tiled and lowers it."""

KERNELS = ("contract_kernel", "contract_split_kernel", "expand_kernel",
           "expand_split_kernel")
SPLIT = ("contract_split_kernel", "expand_split_kernel")


def read(run):
    sl = run.slice
    if sl is None:
        return None
    spent = sl.summed(cats=("kernel",), match=KERNELS)
    if spent <= 0:
        return None
    return 100.0 * sl.summed(cats=("kernel",), match=SPLIT) / spent
