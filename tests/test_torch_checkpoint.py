"""The port's checkpoints (utils/checkpoint.py): a whole-state round trip
(params with the loss latents, AMSGrad state, step, EMA), atomic writes,
structure checks, keep-recent and keep-best retention, and best_step /
resolve_step equal to nlt_tpu's on the same scalars.jsonl."""

import json
import os

import numpy as np
import pytest
import torch

from nlt_tpu.utils import checkpoint as jckpt
from nlt_tpu_torch.nlt_test import restore_model, save_params
from nlt_tpu_torch.parallel import train as ttrain
from nlt_tpu_torch.utils import checkpoint as tckpt
from nlt_tpu_torch.utils.config import Config
from nlt_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_model import small_cfg


def _state(seed, ema=True):
    g = torch.Generator().manual_seed(seed)
    params = {"net": {"query": [{"w": torch.randn(2, 2, 3, 4, generator=g),
                                 "b": torch.randn(4, generator=g)}]},
              "loss": {"0": {"alpha": torch.randn(1, 3, generator=g)}}}
    tx = ttrain.make_optimizer(1e-3)
    state = {"params": params, "opt_state": tx.init(params),
             "step": torch.tensor(seed, dtype=torch.int32)}
    if ema:
        state["ema_params"] = {"net": {"query": [
            {"w": params["net"]["query"][0]["w"] * 0.5,
             "b": params["net"]["query"][0]["b"]}]},
            "loss": params["loss"]}
    return state


def test_state_round_trip(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None and mgr.all_steps() == []
    template = _state(0)
    assert mgr.restore(template) == (template, 0)
    state = _state(7)
    state["opt_state"]["mu"]["net"]["query"][0]["w"] += 1.0
    path = mgr.save(7, state)
    assert os.path.basename(path) == "7.pt"
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["7.pt"]  # no temp left
    restored, step = mgr.restore(template)
    assert step == 7 and mgr.latest_step() == 7
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    with pytest.raises(FileExistsError):
        mgr.save(7, state)
    mgr.save(7, state, force=True)


def test_restore_refuses_another_structure(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1, ema=False))
    with pytest.raises(ValueError, match="ema_params"):
        mgr.restore(_state(0, ema=True))
    bad = _state(0, ema=False)
    bad["params"]["net"]["query"][0]["b"] = torch.zeros(5)
    with pytest.raises(ValueError, match="query/0/b"):
        mgr.restore(bad)


def test_keep_recent_without_keep_best(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in range(1, 6):
        mgr.save(s, _state(s, ema=False))
    assert mgr.all_steps() == [4, 5]
    keep_all = tckpt.CheckpointManager(str(tmp_path / "all"), max_to_keep=0)
    for s in range(1, 4):
        keep_all.save(s, _state(s, ema=False))
    assert keep_all.all_steps() == [1, 2, 3]


def _write_scalars(outdir, series):
    os.makedirs(os.path.join(outdir, "summary_vali"), exist_ok=True)
    with open(os.path.join(outdir, "summary_vali", "scalars.jsonl"),
              "a") as h:
        for step, v in series:
            h.write(json.dumps({"tag": "psnr_vali", "value": v,
                                "step": step}) + "\n")


def test_keep_best_retention_matches_nlt_tpu(tmp_path):
    """nlt_tpu's 25-epoch retention scenario (psnr_vali peaks at epoch 7
    and drifts down; keep_recent_epochs 3): after every save and prune
    both managers hold the same steps, and the best one restores."""
    psnr = [20.0 + 10.0 * np.exp(-abs(s - 7) / 6.0) for s in range(1, 26)]
    runs = {}
    for pkg in ("jax", "torch"):
        outdir = str(tmp_path / pkg)
        ckpt_dir = os.path.join(outdir, "checkpoints")
        if pkg == "jax":
            mgr = jckpt.CheckpointManager(ckpt_dir, max_to_keep=3,
                                          keep_best_metric="psnr_vali")
        else:
            mgr = tckpt.CheckpointManager(ckpt_dir, max_to_keep=3,
                                          keep_best_metric="psnr_vali")
        history = []
        for s in range(1, 26):
            if pkg == "jax":
                mgr.save(s, {"w": np.full((4,), float(s))})
                mgr.wait()
            else:
                mgr.save(s, {"w": torch.full((4,), float(s))})
            _write_scalars(outdir, [(s, psnr[s - 1])])
            mgr.prune()
            history.append(sorted(int(x) for x in mgr.all_steps()))
        runs[pkg] = (history, ckpt_dir, mgr)
    assert runs["torch"][0] == runs["jax"][0]
    assert runs["torch"][0][-1] == [7, 23, 24, 25]
    tdir = runs["torch"][1]
    assert tckpt.resolve_step(tdir, "best") == jckpt.resolve_step(
        runs["jax"][1], "best") == 7
    restored, step = runs["torch"][2].restore({"w": torch.zeros(4)}, step=7)
    assert step == 7 and torch.equal(restored["w"], torch.full((4,), 7.0))
    runs["jax"][2].close()


@pytest.mark.parametrize("available", [[1, 2, 3, 4, 5], [3, 4, 5], [4], []])
def test_best_step_matches_nlt_tpu(tmp_path, available):
    outdir = str(tmp_path / "xp")
    _write_scalars(outdir, [(1, 20.0), (2, 25.0), (3, 23.0),
                            (4, float("nan")), (5, 24.0)])
    ckpt_dir = os.path.join(outdir, "checkpoints")
    assert (tckpt.best_step(ckpt_dir, available)
            == jckpt.best_step(ckpt_dir, available))


def test_resolve_step_matches_nlt_tpu(tmp_path):
    outdir = str(tmp_path / "xp")
    _write_scalars(outdir, [(1, 20.0), (2, 25.0), (3, 23.0)])
    ckpt_dir = os.path.join(outdir, "checkpoints")
    for spec in (None, "latest", "7", 7, "best"):
        assert (tckpt.resolve_step(ckpt_dir, spec)
                == jckpt.resolve_step(ckpt_dir, spec)), spec
    with pytest.raises(ValueError, match="'best', or 'latest'"):
        tckpt.resolve_step(ckpt_dir, "bset")
    mgr = tckpt.CheckpointManager(ckpt_dir)
    for s in (1, 2, 3):
        mgr.save(s, {"w": torch.zeros(1)})
    assert tckpt.resolve_step(ckpt_dir, "best") == 2
    cwd = os.getcwd()
    try:  # a relative ckpt dir from inside the outdir
        os.chdir(outdir)
        assert tckpt.best_step("checkpoints", [1, 2, 3]) == (2, 25.0)
    finally:
        os.chdir(cwd)


def test_restore_model_prefers_ema_and_resolves_best(tmp_path):
    """nlt_test.restore_model reads trainvali's format: the EMA where the
    state keeps one, 'best' by the logged psnr_vali; save_params writes
    the same format with the params alone."""
    from nlt_tpu_torch.models.nlt import Model

    cfg = Config(small_cfg())
    model = Model(cfg, device="cpu")
    outdir = str(tmp_path / "run")
    ckpt_dir = os.path.join(outdir, "checkpoints")
    mgr = tckpt.CheckpointManager(ckpt_dir)
    tx = ttrain.make_optimizer(1e-3)
    states = {}
    for s in (1, 2, 3):
        st = ttrain.init_state(model, tx, torch.Generator().manual_seed(s),
                               ema_decay=0.9)
        st["ema_params"] = ttrain.init_state(
            model, tx, torch.Generator().manual_seed(10 + s))["params"]
        mgr.save(s, st)
        states[s] = st
    _write_scalars(outdir, [(1, 20.0), (2, 26.0), (3, 23.0)])
    _, best = restore_model(cfg, ckpt_dir, step="best", device="cpu")
    assert best["step"] == 2
    for a, b in zip(tree_leaves(best["params"]),
                    tree_leaves(states[2]["ema_params"])):
        assert torch.equal(a, b)
    _, latest = restore_model(cfg, ckpt_dir, device="cpu")
    assert latest["step"] == 3
    with pytest.raises(FileNotFoundError):
        restore_model(cfg, ckpt_dir, step=9, device="cpu")
    pdir = str(tmp_path / "params_only")
    save_params(states[1]["params"], pdir, step=4)
    _, only = restore_model(cfg, pdir, device="cpu")
    assert only["step"] == 4
    for a, b in zip(tree_leaves(only["params"]),
                    tree_leaves(states[1]["params"])):
        assert torch.equal(a, b)
