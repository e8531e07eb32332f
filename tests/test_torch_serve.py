"""nlt_tpu_torch.serve.Server against nlt_tpu.serve.Server end to end:
the same params (nlt_tpu's fresh init, converted and saved as a port
checkpoint), the same requests, with and without a baked observation
pyramid, fused stages on."""

import json
import os
from os.path import join

import jax
import numpy as np
import pytest
import torch

from nlt_tpu import serve as jserve
from nlt_tpu.networks import convnet as jconvnet
from nlt_tpu.utils.config import Config as JConfig
from nlt_tpu_torch import serve as tserve
from nlt_tpu_torch.convert import params_from_jax
from nlt_tpu_torch.nlt_test import save_params
from nlt_tpu_torch.utils.config import Config as TConfig
from tests.test_torch_model import make_batch, small_cfg
from tests.test_torch_nlt_test import make_scene, scene_cfg, write_runs

# Float outputs: the whole model in float32, summed in other orders.
TOL = 1e-4


class _Dataset:
    """The iterate() contract of nlt_tpu's datasets, over fixed batches."""

    def __init__(self, batches):
        self.batches = batches

    def iterate(self, seed=0, drop_remainder=True):
        del seed, drop_remainder
        return iter(self.batches)


OBS = _Dataset([make_batch(10, n=2), make_batch(11, n=2)])


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(make_jax, make_port): Server factories over one set of params."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jconvnet, "_FUSED_STAGE", True)
    mp.setenv("NLT_TPU_FUSED_STAGE", "1")
    cfg = small_cfg()
    jdir = str(tmp_path_factory.mktemp("jax") / "checkpoints")
    tdir = str(tmp_path_factory.mktemp("port") / "checkpoints")
    ref = jserve.Server(jdir, config=JConfig(cfg))
    params = jax.tree_util.tree_map(np.asarray, ref.state["params"])
    save_params(params_from_jax(params), tdir)

    cache = {None: ref}

    def make_jax(pack=None, baked=False):
        """One nlt_tpu Server per pack (its jit cache is per instance),
        with the pyramid baked or cleared."""
        s = cache.get(pack)
        if s is None:
            s = cache[pack] = jserve.Server(jdir, config=JConfig(cfg),
                                            pack=pack)
            s.state = dict(s.state, params=ref.state["params"])
        if baked:
            s.precompute_obs(OBS, n_obs_batches=2)
        else:
            s._feat_agg, s._predict = None, None
        return s

    def make_port(**kw):
        return tserve.Server(tdir, config=TConfig(cfg), device="cpu", **kw)

    yield make_jax, make_port
    mp.undo()


@pytest.mark.parametrize("baked", [False, True])
def test_predict_matches(servers, baked):
    make_jax, make_port = servers
    results = {}
    for pack in (None, "uint8"):
        js, ts = make_jax(pack=pack, baked=baked), make_port(pack=pack)
        if baked:
            ts.precompute_obs(OBS, n_obs_batches=2)
        req = make_batch(12, n=2)
        want, got = js.predict(req), ts.predict(req)
        assert set(got) == set(want) == {"pred_camspc", "pred"}
        results[pack] = got
        for k in want:
            assert got[k].shape == want[k].shape
            assert got[k].dtype == want[k].dtype
            if pack is None:
                np.testing.assert_allclose(got[k], want[k], atol=TOL,
                                           rtol=TOL)
            else:  # quantized: a value near a rounding edge may flip
                diff = np.abs(got[k].astype(int) - want[k].astype(int))
                assert diff.max() <= 1, (k, diff.max())
    np.testing.assert_allclose(
        results["uint8"]["pred_camspc"] / 255.0,
        np.clip(results[None]["pred_camspc"], 0, 1), atol=1 / 255 + 1e-6)


def test_fields_subset_and_benchmark(servers):
    _, make_port = servers
    ts = make_port(fields=["pred_camspc"])
    ts.precompute_obs(OBS)
    req = make_batch(13, n=1)
    out = ts.predict(req)
    assert set(out) == {"pred_camspc"}
    full = make_port()
    full.precompute_obs(OBS)
    np.testing.assert_array_equal(out["pred_camspc"],
                                  full.predict(req)["pred_camspc"])
    stats = ts.benchmark(req, n=2)
    assert stats["fps"] > 0 and stats["latency_s"] > 0


def test_unported_surfaces_raise(servers, tmp_path):
    """What is still not ported is sharded serving (one device)."""
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        tserve.Server(str(tmp_path), config=TConfig(small_cfg()),
                      device="cpu", shard=True)
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        tserve.main(["--ckpt", str(tmp_path), "--shard", "--device", "cpu"])


@pytest.mark.parametrize("pack", [None, "uint8"])
def test_predict_ids_matches(servers, pack):
    """predict(ids=) serves from the device input cache: the first call
    misses every row, a repeat hits every row; the predictions equal
    predict() bit for bit and nlt_tpu's predict(ids=) within TOL (1 LSB
    packed)."""
    make_jax, make_port = servers
    js, ts = make_jax(pack=pack, baked=True), make_port(pack=pack)
    ts.precompute_obs(OBS, n_obs_batches=2)
    req = make_batch(15, n=2)
    ids = ["a", "b"]
    streamed = ts.predict(req)
    first = ts.predict(req, ids=ids)
    assert ts._input_cache.stats()["misses"] == 2
    again = ts.predict(req, ids=ids)
    stats = ts._input_cache.stats()
    assert (stats["hits"], stats["misses"], stats["examples"]) == (2, 2, 2)
    one = ts.predict({k: v[1:] for k, v in req.items()}, ids=["b"])
    assert ts._input_cache.stats()["hits"] == 3
    want = js.predict(req, ids=ids)
    for k in want:
        np.testing.assert_array_equal(first[k], streamed[k])
        np.testing.assert_array_equal(again[k], streamed[k])
        np.testing.assert_array_equal(one[k], streamed[k][1:])
        assert first[k].dtype == want[k].dtype
        if pack is None:
            np.testing.assert_allclose(first[k], want[k], atol=TOL, rtol=TOL)
        else:
            diff = np.abs(first[k].astype(int) - want[k].astype(int))
            assert diff.max() <= 1, (k, diff.max())


def test_invalidate_serves_new_content(servers):
    """A cached id is served as cached until invalidate(ids) drops it;
    then the new content under the same id is served."""
    _, make_port = servers
    ts = make_port(pack="uint8")
    old, new = make_batch(16, n=1), make_batch(17, n=1)
    want_old, want_new = ts.predict(old), ts.predict(new)
    assert any(not np.array_equal(want_old[k], want_new[k])
               for k in want_old)
    ts.predict(old, ids=["x"])
    stale = ts.predict(new, ids=["x"])  # the cached content wins
    for k in want_old:
        np.testing.assert_array_equal(stale[k], want_old[k])
    ts.invalidate(["x"])
    assert ts._input_cache.stats()["examples"] == 0
    fresh = ts.predict(new, ids=["x"])
    for k in want_new:
        np.testing.assert_array_equal(fresh[k], want_new[k])
    ts.invalidate()
    assert ts._input_cache.stats()["examples"] == 0


def test_zero_cap_cache_streams(tmp_path):
    """cache_device_mb = 0: every row misses and streams, nothing is
    kept, and the predictions are the streamed ones."""
    ts = tserve.Server(str(tmp_path / "none"),
                       config=TConfig(small_cfg(cache_device_mb=0)),
                       device="cpu")
    req = make_batch(18, n=2)
    want = ts.predict(req)
    for _ in range(2):
        got = ts.predict(req, ids=["p", "q"])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    stats = ts._input_cache.stats()
    assert (stats["hits"], stats["misses"], stats["examples"]) == (0, 4, 0)
    assert ts.benchmark(req, n=2, ids=["p", "q"])["fps"] > 0


@pytest.mark.parametrize("pack", [None, "uint8"])
def test_export_round_trip(servers, tmp_path, pack):
    """A bundle of bs 1 and 2 serves bit-equal to the live server,
    dispatches on the leading dimension, and refuses a bs it does not
    hold, a field of another shape or dtype, a missing field, and a
    device type other than the one it was exported on."""
    _, make_port = servers
    ts = make_port(pack=pack)
    ts.precompute_obs(OBS, n_obs_batches=2)
    path = str(tmp_path / "bundle.nltx")
    req = make_batch(19, n=2)
    assert ts.export(path, req, bs_list=[2, 1]) == path
    with open(path, "rb") as h:
        header = json.loads(h.read(int.from_bytes(h.read(8), "little")))
    assert header["format"] == tserve.EXPORT_FORMAT
    assert header["pack"] == pack
    assert [(p["bs"], p["device"]) for p in header["programs"]] == [
        (1, "cpu"), (2, "cpu")]
    assert header["programs"][0]["fields"]["base"] == [
        [1, 32, 32, 3], "float32"]
    es = tserve.ExportedServer(path, device="cpu")
    assert es.batch_sizes == [1, 2]
    for bs in (1, 2):
        r = {k: v[:bs] for k, v in req.items()}
        want, got = ts.predict(r), es.predict(r)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="batch size 3"):
        es.predict(make_batch(20, n=3))
    bad = dict(req, base=req["base"][:, :16])
    with pytest.raises(ValueError, match="'base'"):
        es.predict(bad)
    with pytest.raises(ValueError, match="'cvis'"):
        es.predict(dict(req, cvis=req["cvis"].astype(np.float64)))
    with pytest.raises(ValueError, match="missing field 'warp'"):
        es.predict({k: v for k, v in req.items() if k != "warp"})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.ExportedServer(path)  # the default device is cuda
    with open(path, "r+b") as h:  # a bundle recorded for another device
        blob = h.read()
    patched = blob.replace(b'"device": "cpu"', b'"device": "xpu"')
    with open(str(tmp_path / "xpu.nltx"), "wb") as h:
        h.write(patched)
    with pytest.raises(ValueError, match="exported for xpu"):
        tserve.ExportedServer(str(tmp_path / "xpu.nltx"), device="cpu")


def test_restore_without_checkpoint_fresh_inits(tmp_path):
    ts = tserve.Server(str(tmp_path / "none"), config=TConfig(small_cfg()),
                       device="cpu")
    assert ts.state["step"] == 0
    w = ts.state["params"]["net"]["query"][0]["w"]
    assert w.device.type == "cpu" and torch.isfinite(w).all()
    assert not os.path.exists(str(tmp_path / "none"))


@pytest.fixture(scope="module")
def scene_runs(tmp_path_factory):
    """A synthesized 32^2 scene and both packages' run dirs over it (the
    same params); returns (config, jax ckpt dir, port ckpt dir)."""
    root = str(tmp_path_factory.mktemp("scene_runs"))
    cfg = scene_cfg(make_scene(join(root, "scene"), n_test=3))
    return (cfg,) + write_runs(root, cfg)


@pytest.mark.parametrize("missing", [False, True])
def test_precompute_obs_without_dataset(servers, scene_runs, missing):
    """precompute_obs() with no dataset builds the config's training
    split, as nlt_tpu's does, and the two pyramids agree; where the
    data is missing both fall back to the requests' own observations."""
    cfg, jdir, tdir = scene_runs
    if missing:
        cfg = dict(cfg, data_root=cfg["data_root"] + "_missing")
    js = jserve.Server(jdir, config=JConfig(cfg))
    ts = tserve.Server(tdir, config=TConfig(cfg), device="cpu")
    js.precompute_obs()
    ts.precompute_obs()
    if missing:
        assert js._feat_agg is None and ts._feat_agg is None
        return
    assert len(ts._feat_agg) == len(js._feat_agg)
    for got, want in zip(ts._feat_agg, js._feat_agg):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


def test_serve_cli(servers, scene_runs, tmp_path):
    """The CLI's two modes: streamed and cached benchmark stats, or an
    export bundle of the --export_bs sizes that serves bit-equal to the
    live server."""
    cfg, _, tdir = scene_runs
    stats = tserve.main(["--ckpt", tdir, "--bs", "1", "--pack", "uint8",
                         "--device", "cpu"])
    assert sorted(stats) == ["cached", "streamed"]
    for st in stats.values():
        assert st["latency_s"] > 0 and st["fps"] > 0
    path = str(tmp_path / "cli.nltx")
    assert tserve.main(["--ckpt", tdir, "--pack", "uint8", "--export", path,
                        "--export_bs", "1,2", "--device", "cpu"]) == path
    es = tserve.ExportedServer(path, device="cpu")
    assert es.batch_sizes == [1, 2] and es.pack == "uint8"
    live = tserve.Server(tdir, config=TConfig(cfg), pack="uint8",
                         device="cpu")
    live.precompute_obs()
    req = make_batch(21, n=2)
    for k, v in live.predict(req).items():
        np.testing.assert_array_equal(es.predict(req)[k], v)

