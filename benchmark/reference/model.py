"""The NLT model in plain float32 PyTorch.

Dataflow (the recipe's ``model = nlt`` with ``use_obs`` and
``skip_connect_base``; kernel = stride = 2, no norm, no pooling,
LeakyReLU 0.3):

- query input cat(base, cvis, lvis), observation input nn_rgb - nn_base;
- a dual U-Net: at every contracting level the observation path runs its
  stage, the query stage's output is concatenated with it and pushed as
  a skip; every expanding stage and the final 1x1 conv pop a skip and
  concatenate it first (the first expanding stage pops the last level,
  its own input);
- a contracting stage is conv(2, stride 2) -> LeakyReLU -> conv(2,
  stride 1, TF SAME: one zero row and column after) -> LeakyReLU; an
  expanding stage is the transposed pair (transposed conv(2, stride 2)
  -> LeakyReLU -> the transpose of the SAME stride-1 conv -> LeakyReLU);
  the first and last stages are bare 1x1 convs;
- the prediction plus the base, texel (0, 0) set to 0, resampled
  bilinearly through the warp (x, y in [0, 1] of the UV map, scaled to
  texels; taps outside the map read 0) into camera space;
- serving substitutes a baked observation pyramid for the observation
  path: each contracting level's observation features averaged over a
  batch of training examples' rgb - base;
- the training target is rgb_camspc times the resampled foreground
  (ones with texel (0, 0) set to 0).

Weights are a dict of named float32 tensors, HWIO kernels
(``weight_shapes``); activations are NCHW inside. ``rnd`` is the
rounding of ``precision.py`` applied to every layer's input and
weights and to the U-Net's output (None: float32 throughout).
"""

import math

import torch
import torch.nn.functional as F

QUERY_IN = 5        # base (3) + cvis (1) + lvis (1)
OBS_IN = 3          # nn_rgb - nn_base
LRELU_SLOPE = 0.3


def feat_n(min_n, max_n, final_n=3):
    """The U-Net's channel schedule (nlt/util/net.py of the source):
    powers of two from min_n up to max_n, mirrored back down, then
    halving to final_n."""
    chans = [2 ** i for i in range(int(math.log2(min_n)) + 1,
                                   int(math.log2(max_n)) + 1)]
    if not chans or chans[0] != min_n:
        chans = [min_n] + chans
    if chans[-1] != max_n:
        chans.append(max_n)
    chans += chans[::-1]
    chans += [2 ** i for i in range(int(math.log2(chans[-1])) - 1,
                                    int(math.log2(final_n)), -1)]
    while chans and chans[-1] < final_n:
        chans.pop()
    return chans + [final_n]


def check_recipe(cfg):
    """The recipe keys this reference implements; anything else raises."""
    want = {"kernel": 2, "stride": 2, "norm": "none", "pool": "none",
            "act": "leakyrelu", "use_obs": True, "skip_connect_base": True}
    for key, val in want.items():
        got = cfg[key]
        if isinstance(got, str):
            got = got.lower()
        if got != val:
            raise NotImplementedError("reference: %s = %r (implements %r)"
                                      % (key, cfg[key], val))
    if (cfg["imh"], cfg["imw"]) != (cfg["uvh"], cfg["uvw"]):
        raise NotImplementedError("reference: camera and UV sizes differ")


def stages(cfg):
    """The query stages in forward order: (kind, name, [HWIO shapes]) with
    kind 'in' (1x1, contracting level), 'contract', 'expand', 'out'; and
    the observation stages of the contracting levels likewise."""
    n = feat_n(cfg["depth0"], cfg["depth"])
    query = [("in", "query.0", [(1, 1, QUERY_IN, n[0])])]
    obs = [("in", "obs.0", [(1, 1, OBS_IN, n[0])])]
    o_ch, q_ch = n[0], 2 * n[0]
    skips, prev = [q_ch], 0
    for i, c in enumerate(n[:-1], start=1):
        if c >= prev:
            obs.append(("contract", "obs.%d" % len(obs),
                        [(2, 2, o_ch, c), (2, 2, c, c)]))
            query.append(("contract", "query.%d" % i,
                          [(2, 2, q_ch, c), (2, 2, c, c)]))
            o_ch, q_ch = c, 2 * c
            skips.append(q_ch)
        else:
            q_ch += skips.pop()
            query.append(("expand", "query.%d" % i,
                          [(2, 2, q_ch, c), (2, 2, c, c)]))
            q_ch = c
        prev = c
    q_ch += skips.pop()
    query.append(("out", "query.%d" % (len(n[:-1]) + 1),
                  [(1, 1, q_ch, n[-1])]))
    return query, obs


def weight_shapes(cfg):
    """[(name, shape)] of every U-Net weight and bias, query then obs,
    in forward order: '<net>.<stage>.<conv>.w' (HWIO) and '.b'."""
    query, obs = stages(cfg)
    out = []
    for _, name, shapes in query + obs:
        for j, shp in enumerate(shapes):
            out.append(("%s.%d.w" % (name, j), shp))
            out.append(("%s.%d.b" % (name, j), (shp[3],)))
    return out


def _ident(t):
    return t


def _conv(x, w, b, rnd, stride=1, pad_after=0):
    """NCHW correlation with an HWIO kernel, zero padding after."""
    if pad_after:
        x = F.pad(x, (0, pad_after, 0, pad_after))
    return F.conv2d(rnd(x), rnd(w).permute(3, 2, 0, 1), rnd(b),
                    stride=stride)


def _deconv(x, w, b, rnd, stride):
    """Transposed conv: each input pixel adds w's k x k block; stride 1 is
    the transpose of the SAME (pad after) conv, cropped to the input."""
    h, wd = x.shape[2:]
    y = F.conv_transpose2d(rnd(x), rnd(w).permute(2, 3, 0, 1), rnd(b),
                           stride=stride)
    if stride == 1:
        y = y[:, :, :h, :wd]
    return y


def _lrelu(x):
    return torch.where(x >= 0, x, x * LRELU_SLOPE)


def _stage(kind, name, weights, x, rnd):
    w = [weights["%s.%d.w" % (name, j)] for j in range(2)
         if "%s.%d.w" % (name, j) in weights]
    b = [weights["%s.%d.b" % (name, j)] for j in range(len(w))]
    if kind in ("in", "out"):
        return _conv(x, w[0], b[0], rnd)
    if kind == "contract":
        y = _lrelu(_conv(x, w[0], b[0], rnd, stride=2))
        return _lrelu(_conv(y, w[1], b[1], rnd, pad_after=1))
    y = _lrelu(_deconv(x, w[0], b[0], rnd, 2))
    return _lrelu(_deconv(y, w[1], b[1], rnd, 1))


def unet(cfg, weights, x_query, x_obs=None, pyramid=None, rnd=None):
    """The dual U-Net on NCHW inputs; `pyramid`: one observation feature
    map per contracting level in place of the observation path."""
    rnd = rnd or _ident
    query, obs = stages(cfg)
    skips, level, x, o = [], 0, x_query, x_obs
    for kind, name, _ in query:
        if kind in ("in", "contract"):
            q = _stage(kind, name, weights, x, rnd)
            if pyramid is None:
                o = _stage(obs[level][0], obs[level][1], weights, o, rnd)
                agg = o
            else:
                agg = pyramid[level].expand(q.shape[0], -1, -1, -1)
            level += 1
            x = torch.cat((q, agg), dim=1)
            skips.append(x)
        else:
            x = torch.cat((x, skips.pop()), dim=1)
            x = _stage(kind, name, weights, x, rnd)
    return rnd(x)   # the compute dtype's output, back in float32


def to_float(batch, device):
    """Wire format (uint8 images, float16 warp) -> float32 NHWC tensors."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v).to(device)
        out[k] = t.float() / 255.0 if t.dtype == torch.uint8 else t.float()
    return out


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _zero_corner(x):
    """x (NHWC) with texel (0, 0) of every image set to 0."""
    mask = torch.ones_like(x[:1, :, :, :1])
    mask[:, 0, 0] = 0.0
    return x * mask


def resample(img, warp):
    """Bilinear lookup of NHWC img at warp (N, Ho, Wo, 2) = (x, y) in
    texels; taps outside the image read 0."""
    n, h, w, c = img.shape
    x, y = warp[..., 0], warp[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    flat = img.reshape(n, h * w, c)
    out = 0.0
    for dx, dy, wgt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                        (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, -1)
        val = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        out = out + val.reshape(n, *warp.shape[1:3], c) * torch.where(
            inside, wgt, torch.zeros_like(wgt))[..., None]
    return out


def _warp_px(cfg, warp):
    return torch.stack((warp[..., 0] * cfg["uvw"], warp[..., 1] * cfg["uvh"]),
                       dim=-1)


def predict(cfg, weights, batch, pyramid=None, rnd=None):
    """pred_camspc (N, imh, imw, 3) of a float batch (``to_float``)."""
    base = batch["base"]
    xq = _nchw(torch.cat((base, batch["cvis"], batch["lvis"]), dim=-1))
    xo = None
    if pyramid is None:
        xo = _nchw(batch["nn_rgb"] - batch["nn_base"])
    pred = _nhwc(unet(cfg, weights, xq, xo, pyramid, rnd)) + base
    return resample(_zero_corner(pred), _warp_px(cfg, batch["warp"]))


def target(cfg, batch):
    """gt_camspc: the camera photo times the resampled foreground."""
    ones = _zero_corner(torch.ones_like(batch["base"]))
    return batch["rgb_camspc"] * resample(ones, _warp_px(cfg, batch["warp"]))


def obs_pyramid(cfg, weights, batch, rnd=None):
    """The baked pyramid: every contracting level's observation features
    of rgb - base, averaged over the batch (1, C, H, W each)."""
    rnd = rnd or _ident
    _, obs = stages(cfg)
    x = _nchw(batch["rgb"] - batch["base"])
    out = []
    for kind, name, _ in obs:
        x = _stage(kind, name, weights, x, rnd)
        out.append(x.mean(dim=0, keepdim=True))
    return out


def pack_uint8(x):
    """[0, 1] images to uint8: clamp, scale by 255, round half to even."""
    return torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
