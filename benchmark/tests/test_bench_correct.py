"""The comparison that decides ``correct``, at a size a CPU run holds:
a sound run is correct; the control (the reference in float8 in the
program's place) is not; and a run is not correct with the timed path
broken underneath by each fault its cell can have: a training step that
returns its state unchanged, a step on half its batch (the mean over
the rest), an answer altered where it is produced."""

import numpy as np
import pytest
import torch

from benchmark.harness import correct, weights
from benchmark.reference import steps as ref_steps
from nlt_tpu_torch.parallel import train as train_mod
from nlt_tpu_torch.serve import Server
from nlt_tpu_torch.utils.tree import tree_map

from benchmark.tests import tiny

TRAIN = ["dragon_specular.train", "dragon_sss.train"]
SERVE = ["dragon_specular.serve_bs1", "dragon_specular.sweep_bs4"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
    result, run = tiny.run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", TRAIN)
def test_training_control_is_not_correct(cell):
    _, run = tiny.run(cell)
    cfg, seed = run.cfg, run.seed
    w0 = weights.unet(cfg, seed, "cpu")
    lp = weights.lpips(seed, "cpu")
    batches = run.outputs["batches"]
    ref = ref_steps.train(cfg, w0, lp, batches)
    control = ref_steps.train(cfg, w0, lp, batches, precision="fp8")
    ok, checks = correct.judge(correct.train_numbers(control, ref, w0),
                               cfg["limits"])
    assert not ok, checks


@pytest.mark.parametrize("cell", SERVE)
def test_serving_control_is_not_correct(cell):
    _, run = tiny.run(cell)
    cfg = run.cfg
    w0 = weights.unet(cfg, run.seed, "cpu")
    args = (cfg, w0, run.outputs["obs_batch"], run.outputs["requests"])
    number = correct.frame_rms_lsb(ref_steps.frames(*args, precision="fp8"),
                                   ref_steps.frames(*args))
    ok, checks = correct.judge({"frame_rms_lsb": number}, cfg["limits"])
    assert not ok, checks


def _broken_step(monkeypatch, fault):
    make = train_mod.make_train_step

    def make_broken(*args, **kwargs):
        step = make(*args, **kwargs)
        calls = []

        def broken(state, batch, statics=None):
            calls.append(1)
            if fault == "half_batch_after_first" and len(calls) == 1:
                return step(state, batch, statics)
            if fault == "unchanged":
                _, loss, vis = step(tree_map(torch.clone, state), batch,
                                    statics)
                return state, loss, vis
            n = next(iter(batch.values())).shape[0] // 2
            return step(state, tree_map(lambda t: t[:n], batch),
                        tree_map(lambda t: t[:n], statics))

        return broken

    monkeypatch.setattr(train_mod, "make_train_step", make_broken)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_training_fault_is_not_correct(monkeypatch, cell, fault):
    _broken_step(monkeypatch, fault)
    result, _ = tiny.run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_fault_after_the_first_step_fails_the_last_gradient(monkeypatch,
                                                           cell):
    """On the card the first step is the captured step's eager warm-up and
    the later ones replay its graph: a fault in the replays alone leaves
    the first gradient sound and shows in the last one's."""
    _broken_step(monkeypatch, "half_batch_after_first")
    result, _ = tiny.run(cell)
    checks = result["checks"]
    assert checks["grad_rel_l2"]["value"] <= checks["grad_rel_l2"]["limit"]
    last = checks["last_grad_rel_l2"]
    assert last["value"] > last["limit"], checks
    assert not result["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_altered_answer_is_not_correct(monkeypatch, cell):
    predict = Server.predict

    def altered(self, batch, ids=None):
        out = predict(self, batch, ids)
        return {k: np.roll(v, 1, axis=1) for k, v in out.items()}

    monkeypatch.setattr(Server, "predict", altered)
    result, _ = tiny.run(cell)
    assert not result["correct"], result["checks"]
