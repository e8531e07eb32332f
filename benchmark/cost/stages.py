"""The U-Net's stages from a configuration's keys, with the bytes and
FLOPs each has to move and do.

``stage_cost`` is chip_smoke.py's: a fused stage reads its input and
both weights once and writes y2 once (y1 stays on chip), 2 FLOPs a
multiply-add. ``fused_launches`` lists the K2 / K3 launches one training
step or one request makes, in the order the model calls them, each with
the dtype it runs in: a training step runs every stage in the compute
dtype; a request served with a baked (float32) observation pyramid
concatenates it to the query's first 1x1 output, which promotes every
fused query stage to float32, as jnp.concatenate's rule (kept by the
port) does. ``unet_flops`` counts every convolution of the U-Net.
"""

from ..reference import model as ref_model
from . import peaks

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def stage_cost(kind, x_shape, itemsize, o):
    """(bytes, flops) of one fused stage on an (n, h, w, c) input."""
    n, h, w, c = x_shape
    if kind == "contract_stage":
        out_px = n * (h // 2) * (w // 2)
        macs = out_px * (4 * c * o + 4 * o * o)
    else:
        out_px = n * 4 * h * w
        macs = n * h * w * 4 * c * o + out_px * 4 * o * o
    nbytes = itemsize * (n * h * w * c + 4 * c * o + 4 * o * o + 2 * o
                         + out_px * o)
    return nbytes, 2 * macs


def stage_bound_s(kind, x_shape, dtype, o):
    """The least time the chip could take: bytes or operations."""
    nbytes, flops = stage_cost(kind, x_shape, ITEMSIZE[dtype], o)
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.FLOPS[dtype])


def layers(cfg):
    """[(net, kind, input resolution, C, O)] of every stage, in the order
    the model runs them: at each contracting level the observation stage
    first, then the query's; then the expanding stages and the 1x1 out."""
    query, obs = ref_model.stages(cfg)
    out, res, level = [], cfg["uvh"], 0
    for kind, _, shapes in query:
        c, o = shapes[0][2], shapes[0][3]
        if kind in ("in", "contract"):
            oc, oo = obs[level][2][0][2], obs[level][2][0][3]
            out.append(("obs", kind, res, oc, oo))
            level += 1
        out.append(("query", kind, res, c, o))
        if kind == "contract":
            res //= 2
        elif kind == "expand":
            res *= 2
    return out


def fused_launches(cfg, bs, path):
    """[(op, (n, h, w, c), dtype, o)] of the fused stages of one unit:
    path 'train' (a training step's forward: both nets) or 'serve' (a
    request with the baked pyramid: the query net)."""
    dtype = cfg["compute_dtype"]
    out = []
    for net, kind, res, c, o in layers(cfg):
        if kind not in ("contract", "expand"):
            continue
        if path == "serve" and net == "obs":
            continue
        run_dtype = "float32" if path == "serve" else dtype
        op = "contract_stage" if kind == "contract" else "expand_stage"
        out.append((op, (bs, res, res, c), run_dtype, o))
    return out


def unet_flops(cfg, nets=("query", "obs")):
    """Convolution FLOPs of one example through the named nets."""
    total = 0
    for net, kind, res, c, o in layers(cfg):
        if net not in nets:
            continue
        if kind in ("in", "out"):
            total += 2 * res * res * c * o
        elif kind == "contract":
            out_px = (res // 2) ** 2
            total += 2 * out_px * (4 * c * o + 4 * o * o)
        else:
            out_px = (2 * res) ** 2
            total += 2 * (res * res * 4 * c * o + out_px * 4 * o * o)
    return total
