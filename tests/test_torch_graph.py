"""nlt_tpu_torch.parallel.graph (CUDA graphs over in-place state, the
port's jit with donation) on the CPU, at 32^2, depth0 16 / depth 32.

A CPU has no CUDA graphs, so the runner's logic (keys, static buffers,
donation, the output contract, the launch counters) runs here on an
emulated backend, ``EmulatedGraphs``: a capture runs the program on the
static buffers and restores the in-place tensors, a replay runs it again
and writes its outputs into the capture's, as a graph's replay
overwrites its pool. ``HostTraffic`` checks the programs' bodies for
what a capture on the card refuses: a device value read on the host, a
tensor made on the host meeting device tensors (an upload); and the
bodies run with the default device set to "meta", so a tensor made
without naming a device (a host tensor on the card) cannot meet the
program's own tensors at all.
"""

import gc
import traceback
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from nlt_tpu.parallel import train as jtrain
from nlt_tpu_torch.models import get_model_class as torch_model_class
from nlt_tpu_torch.parallel import graph
from nlt_tpu_torch.parallel import train as ttrain
from nlt_tpu_torch.serve import Server
from nlt_tpu_torch.utils.config import Config as TConfig
from nlt_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_torch_model import make_batch, small_cfg
from tests.test_torch_train import (FLAGSHIP_LOSS, batches, build,
                                    check_grads, check_params)


class EmulatedGraphs:
    """graph._CudaGraphs on the CPU: the same calls, replayed by running
    the program again."""

    def __init__(self, device):
        self.device = device

    def warm_up(self, fn, inputs):
        return fn()

    def capture(self, fn, addressed):
        saved = [t.clone() for t in addressed]
        out = fn()
        with torch.no_grad():
            for t, s in zip(addressed, saved):
                t.copy_(s)
        return (fn, out), out

    @staticmethod
    def replay(g):
        fn, out = g
        before = [dict(c) for c in graph.COUNTERS]
        new = fn()
        for counter, was in zip(graph.COUNTERS, before):
            counter.update(was)  # a replay makes no Python calls
        dst, src = [], []
        graph._flatten(out, dst)
        graph._flatten(new, src)
        with torch.no_grad():
            for d, s in zip(dst, src):
                if d is not s:
                    d.copy_(s)


@pytest.fixture
def emulated(monkeypatch):
    """Captured programs on the CPU (the rule's CPU reason lifted)."""
    monkeypatch.setattr(graph, "_graphs_on", lambda device: EmulatedGraphs)
    monkeypatch.setattr(graph, "eager_reason", lambda *a, **kw: None)


@pytest.fixture
def one_thread():
    """Bit-for-bit comparisons need one summation order. The CPU's
    multi-threaded kernels do not keep theirs from run to run (two eager
    runs of the step differ in a few runs of ten), so these run on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(monkeypatch, **over):
    monkeypatch.setenv("NLT_TPU_FUSED_STAGE", "1")
    cfg = small_cfg(**dict({"loss": FLAGSHIP_LOSS}, **over))
    model = torch_model_class("nlt")(TConfig(cfg), device="cpu")
    tx = ttrain.make_optimizer(1e-3)
    state = ttrain.init_state(model, tx, torch.Generator().manual_seed(0),
                              ema_decay=0.9)
    return model, tx, state


def _torch_batches(n_steps, n=2, seed0=10):
    return [{k: torch.from_numpy(v) for k, v in make_batch(seed0 + i,
                                                           n=n).items()}
            for i in range(n_steps)]


def _clone(tree):
    return tree_map(torch.clone, tree)


def test_inplace_step_is_bit_equal_to_the_functional_step(monkeypatch,
                                                          emulated,
                                                          one_thread):
    """Three captured, donated steps (fused stages, cached statics,
    grad_accum 2, nan_guard with a NaN batch second, EMA) against the
    eager functional step from the same state: every leaf and loss bit
    for bit; the state keeps its tensors, the NaN batch skips its
    update, and the runner captured once and replayed twice."""
    model, tx, state = _model(monkeypatch)
    kw = dict(cached_statics=True, grad_accum=2, nan_guard=True,
              ema_decay=0.9)
    functional = ttrain.make_train_step(model, tx, **kw)
    donated = ttrain.make_train_step(model, tx, donate=True, **kw)
    assert isinstance(donated, graph.Captured)
    extract = ttrain.make_static_extractor(model)
    bs = _torch_batches(3)
    bs[1] = dict(bs[1], base=torch.full_like(bs[1]["base"], float("nan")))
    ref, mine = _clone(state), _clone(state)
    ptrs = [t.data_ptr() for t in tree_leaves(mine)]
    for i, b in enumerate(bs):
        with graph.disabled():
            ref, lr, vr = functional(ref, b, extract(ref["params"], b))
        before = _clone(mine)
        out, lm, vm = donated(mine, b, extract(mine["params"], b))
        assert [t.data_ptr() for t in tree_leaves(out)] == ptrs
        assert all(a is b for a, b in zip(tree_leaves(out),
                                          tree_leaves(mine)))
        assert torch.equal(lr, lm) or (lr.isnan() and lm.isnan())
        for a, b in zip(tree_leaves(ref), tree_leaves(mine)):
            assert torch.equal(a, b)
        for k in vr:
            assert torch.equal(vr[k], vm[k]) or i == 1
        if i == 1:  # the NaN batch: params and moments kept
            assert not bool(torch.isfinite(lm))
            for a, b in zip(tree_leaves((before["params"],
                                         before["opt_state"])),
                            tree_leaves((mine["params"],
                                         mine["opt_state"]))):
                assert torch.equal(a, b)
    assert int(mine["step"]) == 3
    assert (donated.captures, donated.replays) == (1, 2)


def test_captured_donated_step_matches_jax(monkeypatch, emulated):
    """The flagship path (fused stages, cached statics, barron + LPIPS),
    captured and donated, against nlt_tpu's jitted donated step:
    test_torch_train.py's tolerances (loss 1e-4 relative over 3 steps;
    the first step's gradients 1e-4 of each leaf's largest; params as
    its check_params)."""
    cfg = small_cfg(loss=FLAGSHIP_LOSS)
    jmodel, jtx, jstate, tmodel, ttx, tstate = build(cfg, True, monkeypatch)
    jstep = jtrain.make_train_step(jmodel, jtx, cached_statics=True)
    tstep = ttrain.make_train_step(tmodel, ttx, cached_statics=True,
                                   donate=True)
    jext = jtrain.make_static_extractor(jmodel)
    text = ttrain.make_static_extractor(tmodel)
    first = None
    for jb, tb in batches(3):
        jstate, jl, _ = jstep(jstate, jb, jext(jstate["params"], jb))
        tstate, tl, _ = tstep(tstate, tb, text(tstate["params"], tb))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        if first is None:
            first = (jax.tree_util.tree_map(np.array, jstate),
                     _clone(tstate))
    (j1, t1) = first
    grads = check_grads(t1["opt_state"]["mu"], j1["opt_state"][0].mu, 1e-4)
    check_params(t1["params"], j1["params"], grads, 1e-5)
    assert tstep.replays == 2


def test_kept_outputs_stay_distinct_and_shapes_key(monkeypatch, emulated,
                                                   one_thread):
    """Losses and vis kept across replays are each their own (the
    output contract); a key is captured at its second call, a second
    batch shape makes a second graph and the first is replayed again;
    the eval step reads the state where it lies (a step's update shows
    in the next eval replay)."""
    model, tx, state = _model(monkeypatch)
    step = ttrain.make_train_step(model, tx, donate=True)
    evaluate = ttrain.make_eval_step(model)
    kept = []
    bs = (_torch_batches(2) + _torch_batches(2, n=4, seed0=20)
          + _torch_batches(1, seed0=30))
    for b in bs:
        state, loss, vis = step(state, b)
        kept.append((loss, vis["pred"]))
    assert (step.captures, step.replays) == (2, 3)
    _, tx2, fresh = _model(monkeypatch)
    plain = ttrain.make_train_step(model, tx2, donate=True)
    with graph.disabled():
        for (loss, pred), b in zip(kept, bs):
            fresh, want, vis = plain(fresh, b)
            assert torch.equal(loss, want)
            assert torch.equal(pred, vis["pred"])
    assert len({loss.data_ptr() for loss, _ in kept}) == len(kept)
    b = _torch_batches(1, seed0=40)[0]
    got = [evaluate(state, b)[0] for _ in range(2)]
    state, _, _ = step(state, b)
    got.append(evaluate(state, b)[0])
    with graph.disabled():
        want = evaluate(state, b)[0]
    assert torch.equal(got[0], got[1]) and torch.equal(got[2], want)
    assert not torch.equal(got[1], got[2])
    assert (evaluate.captures, evaluate.replays) == (1, 2)


def test_server_requests_stay_distinct(monkeypatch, emulated, tmp_path,
                                       one_thread):
    """Server requests answered by replays, enqueued back to back and
    fetched at the end, each equal to the eager answer; bs 1 and 4 make
    two graphs; benchmark's n requests replay; another pack makes
    another graph."""
    monkeypatch.setenv("NLT_TPU_FUSED_STAGE", "1")
    cfg = TConfig(small_cfg(loss=FLAGSHIP_LOSS))
    srv = Server(str(tmp_path / "none"), config=cfg, pack="uint8",
                 device="cpu")
    assert isinstance(srv._program, graph.Captured)
    reqs = [make_batch(40 + i, n=1) for i in range(3)] + [make_batch(50, n=4)]
    outs = [srv._forward(*srv._place(r)) for r in reqs + reqs]
    with graph.disabled():
        want = [srv.predict(r) for r in reqs + reqs]
    for o, w in zip(outs, want):
        for k in w:
            np.testing.assert_array_equal(o[k].numpy(), w[k])
    assert (srv._program.captures, srv._program.replays) == (2, 6)
    srv.benchmark(reqs[0], n=4)
    assert srv._program.replays > 6
    # The packing is part of the key: unpacked answers after packed ones.
    srv.pack = None
    got = [srv.predict(reqs[0]) for _ in range(2)]
    with graph.disabled():
        want = srv.predict(reqs[0])
    for g in got:
        for k in want:
            assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], want[k])


def test_replays_count_launches(emulated):
    """A replay adds what its capture counted; the capture itself adds
    nothing; disabled() runs the body (and its count) eagerly."""
    counter = graph.launch_counter({"probe": 0})

    def body(x):
        counter["probe"] += 1
        return x * 2

    run = graph.Captured(body, name="probe")
    x = torch.ones(3)
    for i in range(1, 4):
        torch.testing.assert_close(run(x * i), x * 2 * i)
        assert counter["probe"] == i
    with graph.disabled():
        run(x)
    assert counter["probe"] == 4
    assert (run.captures, run.replays) == (1, 2)


def test_the_rule_and_its_log(monkeypatch, capsys):
    """The CPU, E-LPIPS and a mesh of two ranks resolve to eager with
    their reasons, logged once when the step is built; the flagship
    model on the card is captured."""
    model, tx, _ = _model(monkeypatch)
    elpips, _, _ = _model(monkeypatch, loss="barron,1e+0elpips")
    two = types.SimpleNamespace(active=True, world=2)
    assert graph.eager_reason("cuda", model=model) is None
    assert "stochastic" in graph.eager_reason("cuda", model=elpips)
    assert "2 rank(s)" in graph.eager_reason("cuda", model=model, mesh=two)
    assert "cpu" in graph.eager_reason("cpu", model=model)
    assert graph.eager_reason("cuda", model=model, mesh=types.SimpleNamespace(
        active=False, world=1)) is None
    capsys.readouterr()
    step = ttrain.make_train_step(elpips, tx, donate=True)
    assert not isinstance(step, graph.Captured)
    assert "train step: eager (device cpu" in capsys.readouterr().out
    # The same rule for a model on the card.
    rule = graph.eager_reason
    monkeypatch.setattr(graph, "eager_reason",
                        lambda device, **kw: rule("cuda", **kw))
    for m, mesh, why in ((elpips, None, "stochastic"),
                         (model, two, "2 rank(s)")):
        step = ttrain.make_train_step(m, tx, donate=True, mesh=mesh)
        assert not isinstance(step, graph.Captured)
        assert why in capsys.readouterr().out
    step = ttrain.make_train_step(model, tx, donate=True)
    assert isinstance(step, graph.Captured)
    assert "train step: CUDA graphs" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# What a capture on the card refuses, checked on the CPU
# ---------------------------------------------------------------------------


def _live_storages():
    return {o.untyped_storage().data_ptr() for o in gc.get_objects()
            if type(o) is torch.Tensor}


class HostTraffic(TorchDispatchMode):
    """Within the mode, every tensor alive before it and every op output
    that reads one is a device tensor; a tensor made inside it from host
    data (torch.tensor, from numpy) and what is computed from such
    tensors alone are host tensors. Records a device value read on the
    host (``_local_scalar_dense``) and a host tensor meeting a device
    tensor in an op (on the card an upload, which stalls a step and
    cannot be captured), with the port's frames that made the call."""

    def __init__(self):
        super().__init__()
        self.device = _live_storages()
        self.host = set()
        self.events = []

    @staticmethod
    def _where():
        return [f"{f.filename.split('nlt_tpu_torch/')[-1]}:{f.lineno}"
                for f in traceback.extract_stack()
                if "nlt_tpu_torch/" in f.filename][-3:]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        host = [t.untyped_storage().data_ptr() in self.host
                or t.untyped_storage().data_ptr() not in self.device
                for t in ins]
        out = func(*args, **kwargs)
        name = str(func)
        if "_local_scalar_dense" in name:
            if not host[0]:
                self.events.append(("host read", name, self._where()))
            return out
        if "lift_fresh" in name or (ins and all(host)):
            made_on_host = True
        else:
            made_on_host = False
            # fill_ takes a 0-dim host value on the host (no upload).
            if any(host) and not (name == "aten.fill_.Tensor"
                                  and ins[1].dim() == 0):
                self.events.append(("upload", name, self._where()))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                p = t.untyped_storage().data_ptr()
                (self.host if made_on_host else self.device).add(p)
                (self.device if made_on_host else self.host).discard(p)
        return out


@pytest.mark.parametrize("over", [
    {},                                                  # shipped recipes
    {"compute_dtype": "bfloat16"},
    {"loss": "barron,1e+0lpips,1e+0ssim"},
    {"norm": "batch"},
    {"remat": "true"},
    {"take_compact_frac": 0.9},
    {"loss": "barron", "kernel": 5, "stride": 1, "pool": "max"},
    {"loss": "barron", "kernel": 2, "stride": 1, "pool": "avg"},
], ids=["flagship", "bf16", "ssim", "batch_norm", "remat", "compact",
        "k5s1_maxpool", "k2s1_avgpool"])
def test_programs_neither_read_back_nor_upload(monkeypatch, over):
    """The captured programs' bodies (a second call: the first fills
    the caches of constants) read no device value on the host and upload
    nothing: the donated step with cached statics, nan_guard and EMA,
    and the eval step. The pooled U-Nets' upconv resizes with weights
    made on the host, cached on the device."""
    model, tx, state = _model(monkeypatch, **over)
    step = ttrain.make_train_step(model, tx, cached_statics=True,
                                  nan_guard=True, ema_decay=0.9, donate=True)
    evaluate = ttrain.make_eval_step(model)
    extract = ttrain.make_static_extractor(model)
    b0, b1 = _torch_batches(2)
    step(state, b0, extract(state["params"], b0))
    evaluate(state, b0)
    statics = extract(state["params"], b1)
    with HostTraffic() as probe, torch.device("meta"):
        step(state, b1, statics)
        evaluate(state, b1)
    assert probe.events == []


@pytest.mark.parametrize("pyramid,over", [
    (True, {}), (False, {}), (True, {"kernel": 5, "stride": 1,
                                     "pool": "max"})],
    ids=["pyramid", "own_observations", "k5s1_maxpool"])
def test_serving_forward_neither_reads_back_nor_uploads(monkeypatch,
                                                        tmp_path, pyramid,
                                                        over):
    """Server's captured forward (bf16 compute, uint8 answers), with a
    baked pyramid and with the request's own observations."""
    monkeypatch.setenv("NLT_TPU_FUSED_STAGE", "1")
    cfg = TConfig(small_cfg(loss=FLAGSHIP_LOSS, compute_dtype="bfloat16",
                            **over))
    srv = Server(str(tmp_path / "none"), config=cfg, pack="uint8",
                 device="cpu")
    if pyramid:
        srv.precompute_obs(types.SimpleNamespace(
            iterate=lambda **kw: iter([make_batch(1), make_batch(2)])),
            n_obs_batches=2)
    req = make_batch(5, n=1)
    srv.predict(req)
    placed = srv._place(req)
    with HostTraffic() as probe, torch.device("meta"):
        srv._forward(*placed)
    assert probe.events == []


def test_host_traffic_sees_an_upload_and_a_read():
    """The probes themselves: a host-made tensor into a device op, a
    device value read on the host; a tensor made without a device (the
    upconv's weights before they were cached on the device) meeting the
    program's."""
    x = torch.ones(3)
    with HostTraffic() as probe:
        y = x * torch.as_tensor(np.float32(2.0))
        float(y.sum())
        float(torch.tensor(1.0) + 1)
    assert [e[0] for e in probe.events] == ["upload", "host read"]
    with pytest.raises(NotImplementedError), torch.device("meta"):
        x * torch.arange(3.0).to(device=x.device)
