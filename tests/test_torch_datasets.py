"""nlt_tpu_torch's Dataset against nlt_tpu's on one synthesized 32^2
scene: the same example ids in the same order per seed and byte-equal
arrays, with the RAM and disk caches (cold and warm epochs), with and
without the uint8 wire (device_normalize), with two observations weighted
by inverse distance, and over two scene roots. Each package reads its
own copy of the scene, so the two disk caches (<root>_cache) never meet.
"""

import glob
import os
import shutil
import subprocess
import sys

import pytest

from nlt_tpu.datasets import get_dataset_class as jax_dataset_class
from nlt_tpu.utils.config import Config as JConfig
from nlt_tpu_torch.datasets import get_dataset_class as torch_dataset_class
from nlt_tpu_torch.utils.config import Config as TConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synthesize(root, n_cams, n_lights, n_test, *extra):
    subprocess.run(
        [sys.executable, os.path.join(REPO, "data_gen", "synthesize.py"),
         "--outroot", root, "--n_cams", str(n_cams), "--n_lights",
         str(n_lights), "--n_test", str(n_test), "--imh", "32", "--uvs",
         "32"] + list(extra), check=True, capture_output=True)


def _copy_scene(root, dst_parent):
    """The scene (its directory and file list) under another parent."""
    name = os.path.basename(root)
    dst = os.path.join(dst_parent, name)
    shutil.copytree(root, dst)
    shutil.copy(root + ".json", dst + ".json")
    return dst


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{'jax': [roots], 'torch': [roots]}: two scenes, one copy each."""
    src = tmp_path_factory.mktemp("src")
    roots = [str(src / "sphere"), str(src / "spheresss")]
    _synthesize(roots[0], 3, 3, 2)
    _synthesize(roots[1], 2, 2, 1, "--sss")
    out = {}
    for pkg in ("jax", "torch"):
        parent = str(tmp_path_factory.mktemp(pkg))
        out[pkg] = [_copy_scene(r, parent) for r in roots]
    return out


def _cfg(cls, roots, **overrides):
    cfg = {
        "dataset": "nlt", "imh": 32, "imw": 32, "uvh": 32, "uvw": 32,
        "bs": 2, "cache": False, "data_root": ",".join(roots),
        "holdout_cam": "C02", "holdout_light": "L002",
    }
    cfg.update(overrides)
    return cls(cfg)


def _assert_same_epochs(jds, tds, seeds, drop_remainder=True):
    assert sorted(jds.files) == sorted(tds.files)
    for seed in seeds:
        jb = list(jds.iterate(seed=seed, drop_remainder=drop_remainder))
        tb = list(tds.iterate(seed=seed, drop_remainder=drop_remainder))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert sorted(a) == sorted(b)
            for k in a:
                if isinstance(a[k], list):
                    assert a[k] == b[k], k
                else:
                    assert a[k].dtype == b[k].dtype, k
                    assert a[k].shape == b[k].shape, k
                    assert a[k].tobytes() == b[k].tobytes(), k


CASES = {
    "no_cache": {},
    "ram": {"cache": "ram"},
    "disk": {"cache": "disk"},
    "disk_uint8": {"cache": "disk", "device_normalize": True},
    "uint8": {"device_normalize": True},
    "n_obs2_inverse_distance": {"n_obs": 2,
                                "obs_weighting": "inverse_distance",
                                "cache": "disk"},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", ["train", "vali"])
def test_batches_byte_equal(scenes, case, mode):
    """Seeds 0 and 1 (a second pass over a disk cache reads its blobs)."""
    kw = CASES[case]
    jds = jax_dataset_class("nlt")(_cfg(JConfig, scenes["jax"][:1], **kw),
                                   mode)
    tds = torch_dataset_class("nlt")(
        _cfg(TConfig, scenes["torch"][:1], **kw), mode)
    _assert_same_epochs(jds, tds, seeds=(0, 1, 0),
                        drop_remainder=mode == "train")


@pytest.mark.parametrize("cache", [False, "disk"])
def test_two_scene_roots_byte_equal(scenes, cache):
    jds = jax_dataset_class("nlt")(
        _cfg(JConfig, scenes["jax"], cache=cache), "train")
    tds = torch_dataset_class("nlt")(
        _cfg(TConfig, scenes["torch"], cache=cache), "train")
    assert any(f.startswith("spheresss/") for f in tds.files)
    _assert_same_epochs(jds, tds, seeds=(3, 4))


@pytest.mark.parametrize("device_normalize", [False, True])
def test_pil_fallback_byte_equal(scenes, monkeypatch, device_normalize):
    """Without the native library (a host with no libpng) the port decodes
    with PIL: the same batches as nlt_tpu's native decode."""
    from nlt_tpu_torch import io_native

    monkeypatch.setattr(io_native, "get_lib", lambda: None)
    kw = {"device_normalize": device_normalize}
    jds = jax_dataset_class("nlt")(_cfg(JConfig, scenes["jax"][:1], **kw),
                                   "train")
    tds = torch_dataset_class("nlt")(
        _cfg(TConfig, scenes["torch"][:1], **kw), "train")
    _assert_same_epochs(jds, tds, seeds=(0,))


@pytest.mark.parametrize("new_hw", [None, 16, 48])
def test_pil_decode_equals_native_decode(scenes, new_hw):
    """The PIL path's decode, normalization and bilinear resize give the
    native decoder's float32 bits: the port's own build of native/nltio.cc
    at every size, and nlt_tpu's at native size (nlt_tpu loads a library
    built with -march=native, whose fused multiply-adds move upsampled
    values by up to 4e-7)."""
    from nlt_tpu import io_native as jio
    from nlt_tpu_torch import io_native as tio

    assert tio.get_lib() is not None, "the native library did not build"
    paths = sorted(glob.glob(os.path.join(scenes["torch"][0], "*", "*.png")))
    assert paths
    for path in paths[:12]:
        got = tio._pil_load_resized(path, new_h=new_hw, new_w=new_hw)
        wants = [tio.load_png_f32(path, new_h=new_hw, new_w=new_hw)]
        if new_hw is None:
            wants.append(jio.load_png_f32(path))
        for want in wants:
            assert got.dtype == want.dtype and got.shape == want.shape, path
            assert got.tobytes() == want.tobytes(), path


def test_test_mode_placeholders_byte_equal(scenes):
    jds = jax_dataset_class("nlt")(_cfg(JConfig, scenes["jax"][:1]), "test")
    tds = torch_dataset_class("nlt")(_cfg(TConfig, scenes["torch"][:1]),
                                     "test")
    _assert_same_epochs(jds, tds, seeds=(0,), drop_remainder=False)


def test_disk_cache_identity_dir(scenes):
    """The blob cache's directory names every knob of the field layout,
    as nlt_tpu's does."""
    kw = {"cache": "disk", "device_normalize": True, "n_obs": 2,
          "obs_weighting": "inverse_distance"}
    jds = jax_dataset_class("nlt")(_cfg(JConfig, scenes["jax"][:1], **kw),
                                   "train")
    tds = torch_dataset_class("nlt")(
        _cfg(TConfig, scenes["torch"][:1], **kw), "train")
    assert (os.path.basename(tds._disk_cache_dir)
            == os.path.basename(jds._disk_cache_dir)
            == "train_uv32_im32_u8_obs2_winverse_distance")


def test_no_libpng_header_skips_the_build(monkeypatch, tmp_path):
    """Where g++ finds no <png.h>, the library is neither built nor
    loaded and PNGs decode with PIL; where it finds one, the header probe
    is what it ran first."""
    from nlt_tpu_torch import io_native

    built = []
    monkeypatch.setattr(io_native, "_lib", None)
    monkeypatch.setattr(io_native, "_tried", False)
    monkeypatch.setattr(io_native, "_so_path",
                        lambda: str(tmp_path / "libnltio-absent.so"))
    monkeypatch.setattr(io_native, "_build", built.append)
    monkeypatch.setattr(io_native, "_have_libpng_header", lambda: False)
    assert io_native.get_lib() is None and built == []
    assert io_native._tried
    monkeypatch.undo()
    assert io_native._have_libpng_header()
