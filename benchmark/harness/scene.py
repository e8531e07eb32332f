"""A seeded synthetic NLT scene in the recipe's wire format.

The NLT data contract as ``device_normalize = True`` ships it: uint8
images (H, W, C) and a float16 warp (H, W, 2) of UV coordinates in
[0, 1]. An example is a (camera, light) pair. As in a captured scene,
the warp and the camera visibility belong to the camera, the light
visibility to the light, and the diffuse base and the photos (rgb in
UV space, rgb_camspc in camera space) to the pair; an example's
neighbour observation (nn_base, nn_rgb, nn_rgb_camspc) is another
example's base and photos. A test-mode query has no photos: its rgb and
rgb_camspc are zeros, as the dataset gives them, and its neighbour is an
example of a separate observation scene.

Images are uniform uint8 noise, an example's base and photos scaled by
its light's gain (drawn in [0.15, 1]): under different lights a scene is
brighter or darker, so the examples of a batch differ in their losses
as captured ones do. Each camera's warp is a rotation,
scaling and shift of the identity inside a centred disk that covers
`coverage` of the frame, and (0, 0) (the blacked-out background texel)
outside it, as chip_smoke.py's make_batch pins it. Everything is drawn
on `device` from one torch.Generator in a few calls and copied to the
host once.
"""

import zlib

import numpy as np
import torch


def subseed(seed, *tags):
    """A 63-bit seed for the named stream of run seed `seed`."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [zlib.crc32(str(t).encode()) for t in tags]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed, device, *tags):
    return torch.Generator(device=device).manual_seed(
        subseed(seed, *tags))


def disk_mask(res, coverage):
    """(res, res) bool: the centred disk that covers `coverage` of the
    frame."""
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    r2 = ((xs - res / 2) ** 2 + (ys - res / 2) ** 2) / (res / 2) ** 2
    return r2 <= coverage * 4 / np.pi


class Scene:
    def __init__(self, seed, tag, res, n_cams, n_lights, photos, coverage,
                 device):
        self.res, self.n_cams, self.n_lights = res, n_cams, n_lights
        self.n = n_cams * n_lights
        g = generator(seed, device, "scene", tag)
        px = res * res
        lit = ("base", "rgb", "rgb_camspc") if photos else ("base",)
        sizes = dict({k: 3 * self.n for k in lit}, cvis=n_cams,
                     lvis=n_lights)
        total = sum(sizes.values()) * px
        flat = torch.randint(0, 256, (total,), generator=g, device=device,
                             dtype=torch.uint8)
        gains = 0.15 + 0.85 * torch.rand(n_lights, generator=g, device=device)
        per_light = flat[:3 * self.n * px * len(lit)].view(
            len(lit), n_cams, n_lights, px * 3)
        per_light.copy_((per_light.float() * gains[None, None, :, None])
                        .round().to(torch.uint8))
        flat = flat.cpu().numpy()
        shapes = {"base": (self.n, res, res, 3), "rgb": (self.n, res, res, 3),
                  "rgb_camspc": (self.n, res, res, 3),
                  "cvis": (n_cams, res, res, 1),
                  "lvis": (n_lights, res, res, 1)}
        at = 0
        self.images = {}
        for k, size in sizes.items():
            self.images[k] = flat[at:at + size * px].reshape(shapes[k])
            at += size * px
        mask = disk_mask(res, coverage)
        self.live = int(mask.sum())   # texels a warp does not pin to (0, 0)
        self.warp = self._warps(g, mask, device)
        self._made = {}     # arrays made once: zero photos, repeated fields

    def _warps(self, g, mask, device):
        res = self.res
        p = torch.stack(torch.meshgrid(
            torch.arange(res, device=device, dtype=torch.float32) / res,
            torch.arange(res, device=device, dtype=torch.float32) / res,
            indexing="xy"), dim=-1) - 0.5                     # (y, x, [x, y])
        u = torch.rand((self.n_cams, 4), generator=g, device=device)
        theta = (u[:, 0] - 0.5) * 0.6                        # +-0.3 rad
        scale = 0.85 + 0.3 * u[:, 1]
        shift = (u[:, 2:] - 0.5) * 0.1
        cos, sin = torch.cos(theta) * scale, torch.sin(theta) * scale
        rot = torch.stack((torch.stack((cos, -sin), -1),
                           torch.stack((sin, cos), -1)), -2)  # (cams, 2, 2)
        w = 0.5 + torch.einsum("cij,yxj->cyxi", rot, p) + shift[:, None, None]
        w = w.clamp(0.0, 1.0) * torch.as_tensor(mask, device=device)[..., None]
        return w.to(torch.float16).cpu().numpy()

    def cam_light(self, e):
        return e // self.n_lights, e % self.n_lights

    def _camera(self, field, c, k):
        """Camera c's field, repeated k times (made once)."""
        src = self.warp if field == "warp" else self.images[field]
        if k == 1:
            return src[c:c + 1]
        key = (field, c, k)
        if key not in self._made:
            self._made[key] = np.repeat(src[c:c + 1], k, axis=0)
        return self._made[key]

    def _zeros(self, k):
        if k not in self._made:
            self._made[k] = np.zeros((k, self.res, self.res, 3), np.uint8)
        return self._made[k]

    def photo(self, field, e, k=1):
        """rows e..e+k of a photo field (zeros in a scene without
        photos)."""
        if field in self.images:
            return self.images[field][e:e + k]
        return self._zeros(k)

    def query(self, e, k=1):
        """The query fields of examples e..e+k (k consecutive lights of one
        camera): views, no copy, but the camera's fields repeated k
        times."""
        c, l = self.cam_light(e)
        if l + k > self.n_lights:
            raise ValueError("lights %d..%d of %d" % (l, l + k, self.n_lights))
        return {"base": self.images["base"][e:e + k],
                "cvis": self._camera("cvis", c, k),
                "lvis": self.images["lvis"][l:l + k],
                "warp": self._camera("warp", c, k),
                "rgb": self.photo("rgb", e, k),
                "rgb_camspc": self.photo("rgb_camspc", e, k)}

    def neighbour(self, e):
        """Training scenes: the same camera under the next light."""
        c, l = self.cam_light(e)
        return c * self.n_lights + (l + 1) % self.n_lights

    def example(self, e):
        """Every array field of example e, (1, ...) each, its neighbour
        from this scene."""
        out = self.query(e)
        j = self.neighbour(e)
        out.update(nn_base=self.images["base"][j:j + 1],
                   nn_rgb=self.photo("rgb", j),
                   nn_rgb_camspc=self.photo("rgb_camspc", j))
        return out


def stack(examples):
    """One batch (the loader's copy) of per-example field dicts."""
    return {k: np.concatenate([ex[k] for ex in examples])
            for k in examples[0]}
