"""nlt_tpu_torch.nlt_test against nlt_tpu.nlt_test on one synthesized
32^2 scene (3 cameras x 3 lights, 5 test views, bs 2, so the last test
batch is a remainder of 1), from the same params: nlt_tpu's
init_state params at two checkpoint steps (PRNGKey 0 and 1), converted
and written with save_params, and a vali scalar log that makes step 1
the best, so `--step best` must pick it. Fused stages on in both
packages (nlt_tpu's Pallas kernels in interpret mode). The port runs on
the CPU (--device cpu).

Frames are uint8 PNGs of float32 predictions summed in other orders: a
value on a rounding edge may move one level, so frames agree within 1
LSB; the metadata and the batch-dir list are equal."""

import json
import os
import shutil
import subprocess
import sys
from glob import glob
from os.path import basename, join, splitext

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from nlt_tpu import nlt_test as jnlt_test
from nlt_tpu.models import get_model_class as jax_model_class
from nlt_tpu.networks import convnet as jconvnet
from nlt_tpu.parallel import train as jtrain
from nlt_tpu.utils import checkpoint as jckpt
from nlt_tpu.utils.config import Config as JConfig
from nlt_tpu_torch import nlt_test as tnlt_test
from nlt_tpu_torch.convert import params_from_jax
from nlt_tpu_torch.models.nlt import Model as TModel
from nlt_tpu_torch.utils.config import Config as TConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TEST = 5


def make_scene(root, n_test=N_TEST):
    subprocess.run(
        [sys.executable, join(REPO, "data_gen", "synthesize.py"),
         "--outroot", root, "--n_cams", "3", "--n_lights", "3",
         "--n_test", str(n_test), "--imh", "32", "--uvs", "32"],
        check=True, capture_output=True)
    return root


def scene_cfg(scene_root, **overrides):
    cfg = {
        "dataset": "nlt", "model": "nlt", "loss": "l1",
        "lpips_weights": "none", "no_batch": False,
        "imh": 32, "imw": 32, "uvh": 32, "uvw": 32,
        "use_obs": True, "skip_connect_base": True, "linear_space": False,
        "depth0": 16, "depth": 16, "kernel": 2, "stride": 2,
        "norm": "None", "act": "leakyrelu", "pool": "None",
        "bs": 2, "cache": False, "data_root": scene_root,
        "holdout_cam": "C02", "holdout_light": "L002", "lr": "1e-3",
        "mgm": -1,
    }
    cfg.update(overrides)
    return cfg


def write_runs(root, cfg, psnr_by_step=((1, 25.0), (2, 20.0))):
    """nlt_tpu's and the port's run dirs, <root>/{jax,torch} with their
    .ini, checkpoints of the same params at each step, and a vali
    scalar log. Returns (jax ckpt dir, port ckpt dir)."""
    jmodel = jax_model_class("nlt")(JConfig(cfg))
    tx = jtrain.make_optimizer(1e-3, -1)
    dirs = {}
    for pkg, cls in (("jax", JConfig), ("torch", TConfig)):
        outdir = join(root, pkg)
        cls(cfg).save(outdir + ".ini")
        os.makedirs(join(outdir, "summary_vali"))
        with open(join(outdir, "summary_vali", "scalars.jsonl"), "w") as h:
            for step, v in psnr_by_step:
                h.write(json.dumps({"tag": "psnr_vali", "value": v,
                                    "step": step}) + "\n")
        dirs[pkg] = join(outdir, "checkpoints")
    mgr = jckpt.CheckpointManager(dirs["jax"])
    for step, _ in psnr_by_step:
        state = jtrain.init_state(jmodel, tx, jax.random.PRNGKey(step - 1))
        mgr.save(step, state)
        params = jax.tree_util.tree_map(np.asarray, state["params"])
        tnlt_test.save_params(params_from_jax(params), dirs["torch"], step)
    mgr.wait()
    mgr.close()
    return dirs["jax"], dirs["torch"]


@pytest.fixture(scope="module")
def fused():
    mp = pytest.MonkeyPatch()
    mp.setattr(jconvnet, "_FUSED_STAGE", True)
    mp.setenv("NLT_TPU_FUSED_STAGE", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, fused):
    """Both packages' nlt_test.main at --step best; returns the two
    video paths and the two vis_test roots."""
    root = str(tmp_path_factory.mktemp("nlt_test"))
    scene = make_scene(join(root, "scene"))
    jckpt_dir, tckpt_dir = write_runs(root, scene_cfg(scene))
    flags = ["--step", "best", "--n_obs_batches", "1", "--fps", "4",
             "--n_data", "1"]
    jview = jnlt_test.main(["--ckpt", jckpt_dir] + flags)
    tview = tnlt_test.main(["--ckpt", tckpt_dir, "--device", "cpu"] + flags)
    return {"jax": jview, "torch": tview, "tckpt": tckpt_dir,
            "jroot": join(root, "jax", "vis_test", "ckpt-1_pred"),
            "troot": join(root, "torch", "vis_test", "ckpt-1_pred")}


def _frames(vis_root):
    """{batch dir name: {file name: uint8 array or metadata dict}}."""
    out = {}
    for d in sorted(glob(join(vis_root, "batch*"))):
        files = {}
        for f in sorted(os.listdir(d)):
            path = join(d, f)
            if f.endswith(".png"):
                files[f] = np.asarray(Image.open(path))
            elif f.endswith("_metadata.json"):
                with open(path) as h:
                    files[f] = json.load(h)
            else:
                files[f] = None
        out[basename(d)] = files
    return out


def test_frames_match_nlt_tpu(runs):
    want, got = _frames(runs["jroot"]), _frames(runs["troot"])
    assert sorted(got) == sorted(want) == [
        "batch%09d" % i for i in range(3)]  # 2 + 2 + a remainder of 1
    n_frames = 0
    for d in want:
        assert sorted(got[d]) == sorted(want[d]), d
        for f, w in want[d].items():
            g = got[d][f]
            if f.endswith(".png"):
                assert g.shape == w.shape and g.dtype == w.dtype, (d, f)
                diff = np.abs(g.astype(int) - w.astype(int)).max()
                assert diff <= 1, (d, f, diff)
                n_frames += f.endswith("_pred.png")
            elif f.endswith("_metadata.json"):
                assert g == w, (d, f)
    assert n_frames == N_TEST
    ids = sorted(m["id"] for files in got.values()
                 for f, m in files.items() if f.endswith("_metadata.json"))
    assert len(ids) == N_TEST and all(i.startswith("test_") for i in ids)


def _n_video_frames(path):
    if path.endswith(".gif"):
        return Image.open(path).n_frames
    import imageio
    return len(imageio.mimread(path))


def test_video_matches_nlt_tpu(runs):
    jview, tview = runs["jax"], runs["torch"]
    assert os.path.isfile(tview)
    assert splitext(tview)[1] == splitext(jview)[1]
    assert _n_video_frames(tview) == _n_video_frames(jview) == N_TEST


def test_batch_size_override(runs, tmp_path):
    """--batch_size_override 3: two batches (3 + 2). With the pyramid
    averaged over every training batch (--n_obs_batches -1, so it does
    not depend on bs), each view's frame equals the bs-2 run's within 1
    LSB (other batch compositions)."""
    src = os.path.dirname(runs["tckpt"])
    frames = {}
    for bs in (2, 3):
        run = str(tmp_path / ("bs%d" % bs))
        shutil.copyfile(src + ".ini", run + ".ini")
        shutil.copytree(runs["tckpt"], join(run, "checkpoints"))
        tnlt_test.main(["--ckpt", join(run, "checkpoints"), "--step", "1",
                        "--batch_size_override", str(bs),
                        "--n_obs_batches", "-1", "--device", "cpu"])
        frames[bs] = _frames(join(run, "vis_test", "ckpt-1_pred"))
    assert [sum(f.endswith("_pred.png") for f in files)
            for _, files in sorted(frames[3].items())] == [3, 2]

    def by_id(run):
        return {m["id"]: files[f.replace("metadata.json", "pred.png")]
                for files in run.values() for f, m in files.items()
                if f.endswith("_metadata.json")}

    want, got = by_id(frames[2]), by_id(frames[3])
    assert sorted(got) == sorted(want) and len(got) == N_TEST
    for id_, g in got.items():
        diff = np.abs(g.astype(int) - want[id_].astype(int)).max()
        assert diff <= 1, (id_, diff)


@pytest.mark.parametrize("flags", [
    ["--n_data", "2"], ["--num_processes", "2"],
    ["--coordinator_address", "localhost:1234"]])
def test_several_devices_raise(runs, flags):
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        tnlt_test.main(["--ckpt", runs["tckpt"], "--device", "cpu"] + flags)


def test_default_device_is_cuda(runs):
    """The entry point runs on the card unless asked for the CPU."""
    assert tnlt_test.parse_args(["--ckpt", "x"]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnlt_test.main(["--ckpt", runs["tckpt"]])


def test_compile_into_video_orders_by_id(tmp_path):
    """Frames come from each dir's metadata ids, sorted by id, whatever
    the order of the dirs and of the files in them; a missing pred.png
    is skipped."""
    frames = {}
    for d, ids in (("b1", ["test_3", "test_1"]), ("b0", ["test_2"]),
                   ("b2", ["test_0"])):
        os.makedirs(str(tmp_path / d))
        for i, id_ in enumerate(ids):
            # One flat colour a frame: exact through a GIF's palette.
            frames[id_] = np.full((8, 8, 3), 40 * int(id_[-1]) + 30,
                                  np.uint8)
            Image.fromarray(frames[id_]).save(
                str(tmp_path / d / ("%d_pred.png" % i)))
            with open(str(tmp_path / d / ("%d_metadata.json" % i)), "w") as h:
                json.dump({"id": id_, "nn_id": "x"}, h)
    os.remove(str(tmp_path / "b2" / "0_pred.png"))
    out = TModel._compile_into_video(
        [str(tmp_path / d) for d in ("b1", "b0", "b2")],
        str(tmp_path / "v.gif"), fps=4)
    im = Image.open(out)
    assert im.n_frames == 3
    for k, id_ in enumerate(["test_1", "test_2", "test_3"]):
        im.seek(k)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                      frames[id_])
