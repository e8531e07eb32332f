"""Arithmetic the per-layer metric readers share (``metrics/*.py``). Each
returns None where the run has nothing to read (no traced slice, no
unit in it, launch counts that do not match the configuration's
stages), and the harness then leaves the metric out."""

from ..cost import peaks, scatter, stages


def device_ms_per_unit(run):
    sl = run.slice
    if sl is None or not sl.units or sl.busy_s() <= 0:
        return None
    return sl.busy_s() / sl.units * 1e3


def idle_share(run):
    sl = run.slice
    if sl is None or sl.window_s <= 0 or sl.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)


def mfu(run, nets, factor):
    """The U-Net's convolution FLOPs of the slice's units (`factor`: 1 for
    a forward, 3 for forward and backward) over the slice's window at the
    compute dtype's dense peak, in %."""
    sl = run.slice
    if sl is None or not sl.units or sl.window_s <= 0 or sl.busy_s() <= 0:
        return None
    flops = (stages.unet_flops(run.cfg, nets) * factor
             * run.info["frames_per_unit"] * sl.units)
    return 100.0 * flops / (sl.window_s
                            * peaks.FLOPS[run.cfg["compute_dtype"]])


def stage_roofline(run, path, kernels):
    """The fused stages' least time (bytes or FLOPs at the peaks) over
    their kernels' device time, in %: the stages from the configuration's
    shapes, as many a unit as the launch counters counted."""
    sl = run.slice
    if sl is None or not sl.units:
        return None
    launches = stages.fused_launches(run.cfg, run.info["bs"], path)
    counted = sl.counters.get("contract_stage", 0) + sl.counters.get(
        "expand_stage", 0)
    if counted != len(launches) * sl.units:
        return None
    work = sl.units * sum(stages.stage_bound_s(op, shape, dtype, o)
                          for op, shape, dtype, o in launches)
    spent = sl.summed(cats=("kernel",), match=kernels)
    return 100.0 * work / spent if spent > 0 else None


def scatter_roofline(run, kernels):
    """K1's bytes bound over its kernels' device time, in %."""
    sl = run.slice
    if (sl is None or not sl.units
            or sl.counters.get("scatter_add_rows", 0) != sl.units):
        return None
    nbytes = scatter.step_bytes(run.cfg, run.info["live_per_example"])
    spent = sl.summed(cats=("kernel",), match=kernels)
    if spent <= 0:
        return None
    return 100.0 * sl.units * nbytes / peaks.HBM_BYTES_PER_S / spent
