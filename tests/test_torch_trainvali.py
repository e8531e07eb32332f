"""nlt_tpu_torch.trainvali against nlt_tpu.trainvali on one synthesized
32^2 scene (depth0 16 / depth 16, bs 2, 2 epochs, float32): the port
starts from nlt_tpu's own init_state(PRNGKey(0)) params, converted and
passed as init_from, and runs on the CPU (--device cpu). Per-epoch
loss_train agrees to 1e-4 relative and loss_vali to 1e-4; psnr_vali,
computed from uint8 vis images, to 0.05 dB (a pixel on a rounding edge
moves one level). The port's run leaves the artifact set of
tests/test_trainvali.py, and a resume continues where both packages'
resumes continue.
"""

import json
import os
import signal
import subprocess
import sys
from glob import glob
from os.path import join

import jax
import pytest
import torch

from nlt_tpu import trainvali as jtrainvali
from nlt_tpu.models import get_model_class as jax_model_class
from nlt_tpu.parallel import train as jtrain
from nlt_tpu.utils.config import Config as JConfig
from nlt_tpu_torch import trainvali as ttrainvali
from nlt_tpu_torch.convert import params_from_jax
from nlt_tpu_torch.nlt_test import restore_model, save_params
from nlt_tpu_torch.utils import checkpoint as tckpt
from nlt_tpu_torch.utils.config import Config as TConfig
from nlt_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
PSNR_ATOL = 0.05


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene") / "sphere")
    subprocess.run(
        [sys.executable, join(REPO, "data_gen", "synthesize.py"),
         "--outroot", root, "--n_cams", "3", "--n_lights", "3",
         "--n_test", "2", "--imh", "32", "--uvs", "32"],
        check=True, capture_output=True)
    return root


def _cfg(scene_root, outroot, **overrides):
    cfg = {
        "dataset": "nlt", "model": "nlt", "loss": "l1",
        "lpips_weights": "none", "no_batch": False,
        "imh": 32, "imw": 32, "uvh": 32, "uvw": 32,
        "use_obs": True, "skip_connect_base": True, "linear_space": False,
        "depth0": 16, "depth": 16, "kernel": 2, "stride": 2,
        "norm": "None", "act": "leakyrelu", "pool": "None",
        "bs": 2, "cache": True, "data_root": scene_root,
        "holdout_cam": "C02", "holdout_light": "L002",
        "lr": "1e-3", "mgm": -1, "epochs": 2,
        "ckpt_period": 1, "vali_period": 1, "vis_train_batches": 1,
        "vali_batches": 1, "keep_recent_epochs": 2, "overwrite": True,
        "outroot": outroot, "xname": "run",
    }
    cfg.update(overrides)
    return cfg


def _ini(path, cfg, cls):
    cls(cfg).save(path)
    return path


def _scalars(outdir, split):
    out = {}
    with open(join(outdir, "summary_%s" % split, "scalars.jsonl")) as h:
        for line in h:
            r = json.loads(line)
            if "value" in r and not r["tag"].startswith("text/"):
                out.setdefault(r["tag"], {})[r["step"]] = r["value"]
    return out


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


def run_both(tmp_path, scene_root, **overrides):
    """nlt_tpu's run and the port's from the same initial params; returns
    (jax outdir, port outdir, jax ini cfg, port ini cfg)."""
    jcfg = _cfg(scene_root, str(tmp_path / "jax"), **overrides)
    jout = jtrainvali.main(["--config", _ini(str(tmp_path / "jax.ini"),
                                             jcfg, JConfig)])
    jmodel = jax_model_class("nlt")(JConfig(jcfg))
    jtx = jtrain.make_optimizer(1e-3, -1)
    jstate = jtrain.init_state(jmodel, jtx, jax.random.PRNGKey(0))
    init_dir = str(tmp_path / "init" / "checkpoints")
    save_params(params_from_jax(jstate["params"]), init_dir)
    tcfg = _cfg(scene_root, str(tmp_path / "torch"), init_from=init_dir,
                **overrides)
    tout = ttrainvali.main(["--config", _ini(str(tmp_path / "torch.ini"),
                                             tcfg, TConfig),
                            "--device", "cpu"])
    return jout, tout, jcfg, tcfg


def assert_runs_agree(jout, tout, epochs):
    jt, tt = _scalars(jout, "train"), _scalars(tout, "train")
    assert sorted(tt["loss_train"]) == list(range(1, epochs + 1))
    for e in tt["loss_train"]:
        assert _close(tt["loss_train"][e], jt["loss_train"][e],
                      LOSS_RTOL), (e, tt["loss_train"], jt["loss_train"])
    jv, tv = _scalars(jout, "vali"), _scalars(tout, "vali")
    for e in tv["loss_vali"]:
        assert _close(tv["loss_vali"][e], jv["loss_vali"][e], LOSS_RTOL), (
            e, tv["loss_vali"], jv["loss_vali"])
        assert abs(tv["psnr_vali"][e] - jv["psnr_vali"][e]) <= PSNR_ATOL, (
            e, tv["psnr_vali"], jv["psnr_vali"])
    assert sorted(tv) == sorted(jv)
    assert sorted(tt) == sorted(jt)


@pytest.mark.parametrize("loss,cache_static", [
    ("l1", False), ("l1", True), ("barron,1e+0lpips", False),
    ("barron,1e+0lpips", True)])
def test_trainvali_matches_nlt_tpu(tmp_path, scene_root, loss, cache_static):
    jout, tout, _, _ = run_both(tmp_path, scene_root, loss=loss,
                                cache_static=cache_static)
    assert_runs_agree(jout, tout, epochs=2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, scene_root):
    tmp_path = tmp_path_factory.mktemp("trained")
    return (tmp_path,) + run_both(tmp_path, scene_root,
                                  loss="barron,1e+0lpips")


def test_artifacts(trained):
    """The artifact set of tests/test_trainvali.py's trainvali run."""
    _, _, outdir, _, _ = trained
    assert os.path.isdir(join(outdir, "checkpoints"))
    assert os.path.exists(outdir.rstrip("/") + ".ini")
    tags = set(_scalars(outdir, "train"))
    assert {"loss_train", "batch_time_train", "texels_per_sec"} <= tags
    assert {"loss_vali", "psnr_vali"} <= set(_scalars(outdir, "vali"))
    assert glob(join(outdir, "vis_train", "epoch*", "all.html"))
    assert glob(join(outdir, "vis_train", "epoch*", "batch*", "*_pred.png"))
    assert glob(join(outdir, "vis_vali", "epoch*", "all.html"))
    assert tckpt.CheckpointManager(join(outdir, "checkpoints")
                                   ).latest_step() == 2
    times = [json.loads(line) for line in
             open(join(outdir, "epoch_times.jsonl"))]
    assert [t["epoch"] for t in times] == [1, 2]
    assert all(t["batches"] == 4 and t["loader_s"] >= 0 for t in times)


def test_resume_continues_as_nlt_tpu(trained):
    """Both runs raised to 3 epochs without overwrite: each resumes from
    its epoch-2 checkpoint (optimizer state included) and the third
    epoch's loss agrees; retention keeps at most 2 checkpoints."""
    tmp_path, jout, tout, jcfg, tcfg = trained
    jcfg = dict(jcfg, epochs=3, overwrite=False)
    tcfg = dict(tcfg, epochs=3, overwrite=False)
    assert jtrainvali.main(["--config", _ini(
        str(tmp_path / "jax3.ini"), jcfg, JConfig)]) == jout
    assert ttrainvali.main(["--config", _ini(
        str(tmp_path / "torch3.ini"), tcfg, TConfig),
        "--device", "cpu"]) == tout
    mgr = tckpt.CheckpointManager(join(tout, "checkpoints"))
    assert mgr.latest_step() == 3
    assert len(mgr.all_steps()) <= 2
    assert_runs_agree(jout, tout, epochs=3)
    model, state = restore_model(TConfig(tcfg), join(tout, "checkpoints"),
                                 step="best", device="cpu")
    assert state["step"] in mgr.all_steps()


def _port_run(tmp_path, scene_root, name, **overrides):
    """The port alone, from its own seeded init; returns the outdir."""
    cfg = _cfg(scene_root, str(tmp_path / name), **overrides)
    return ttrainvali.main(["--config", _ini(
        str(tmp_path / (name + ".ini")), cfg, TConfig), "--device", "cpu"])


@pytest.fixture(scope="module")
def port_losses(tmp_path_factory, scene_root):
    out = _port_run(tmp_path_factory.mktemp("base"), scene_root, "base")
    return _scalars(out, "train")["loss_train"]


@pytest.mark.parametrize("knobs", [
    {"prefetch_batches": 1}, {"cache_device": False},
    {"prefetch_batches": 2, "cache_device": False}])
def test_placement_knobs_keep_the_losses(tmp_path, scene_root, port_losses,
                                         knobs):
    """Placement on a worker (prefetch_batches) and without the device
    example cache feed the same batches in the same order: the same
    losses, bit for bit."""
    out = _port_run(tmp_path, scene_root, "knobs", **knobs)
    assert _scalars(out, "train")["loss_train"] == port_losses


def test_ema_checkpointed_and_restored(tmp_path, scene_root):
    """ema_decay keeps the EMA in the checkpoint and restore_model hands
    it out; vis_dump_raw leaves the raw batch beside the vis."""
    out = _port_run(tmp_path, scene_root, "ema", epochs=1, ema_decay=0.99,
                    vis_dump_raw=True)
    ckpt_dir = join(out, "checkpoints")
    tree = tckpt.CheckpointManager(ckpt_dir).load()
    assert set(tree) == {"params", "opt_state", "step", "ema_params"}
    _, state = restore_model(TConfig(_cfg(scene_root, str(tmp_path))),
                             ckpt_dir, device="cpu")
    ema = tree_leaves(tree["ema_params"])
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(state["params"]), ema))
    assert not all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(tree["params"]), ema))
    assert glob(join(out, "vis_train", "epoch*", "batch*_raw.pickle"))


def test_sigterm_checkpoints_then_resume_finishes(tmp_path, scene_root,
                                                  monkeypatch):
    """A SIGTERM during the first batch: the run checkpoints step 0 and
    returns before any epoch ends; run again, it resumes and finishes.
    The installed handler is called directly (a real signal would end
    the test process if no handler were installed)."""
    from nlt_tpu_torch.parallel import train as ttrain

    make_train_step = ttrain.make_train_step

    def make_preempted(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def preempted(*step_args):
            out = step(*step_args)
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            return out
        return preempted

    handler = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(ttrain, "make_train_step", make_preempted)
    try:
        out = _port_run(tmp_path, scene_root, "pre", overwrite=False)
    finally:
        signal.signal(signal.SIGTERM, handler)
        monkeypatch.undo()
    mgr = tckpt.CheckpointManager(join(out, "checkpoints"))
    assert mgr.all_steps() == [0]
    assert not os.path.exists(join(out, "summary_train", "scalars.jsonl"))
    assert _port_run(tmp_path, scene_root, "pre", overwrite=False) == out
    assert mgr.latest_step() == 2
    assert sorted(_scalars(out, "train")["loss_train"]) == [1, 2]


@pytest.mark.parametrize("bs,uv,grad_accum", [
    (4, 512, None), (8, 512, None), (6, 512, None), (8, 512, 1),
    (2, 1024, None)])
def test_fence_grad_accum_matches_nlt_tpu(bs, uv, grad_accum):
    cfg = {"bs": bs, "uvh": uv, "uvw": uv}
    if grad_accum is not None:
        cfg["grad_accum"] = grad_accum
    assert (ttrainvali.fence_grad_accum(TConfig(cfg))
            == jtrainvali.fence_grad_accum(JConfig(cfg), n_devices=1))


def test_bare_config_name_reads_nlt_tpu_config_dir():
    assert ttrainvali.resolve_config_path("sphere512_specular.ini") == join(
        REPO, "nlt_tpu", "config", "sphere512_specular.ini")
    assert os.path.isfile(ttrainvali.resolve_config_path(
        "sphere512_specular.ini"))


def test_several_devices_not_ported(tmp_path, scene_root):
    ini = _ini(str(tmp_path / "t.ini"),
               _cfg(scene_root, str(tmp_path / "o")), TConfig)
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        ttrainvali.main(["--config", ini, "--device", "cpu", "--n_tile",
                         "2"])
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        ttrainvali.main(["--config", ini, "--device", "cpu",
                         "--num_processes", "2"])
