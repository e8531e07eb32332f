"""nlt_tpu_torch.serve.Server against nlt_tpu.serve.Server end to end:
the same params (nlt_tpu's fresh init, converted and saved as a port
checkpoint), the same requests, with and without a baked observation
pyramid, fused stages on."""

import os

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
    _, make_port = servers
    ts = make_port()
    with pytest.raises(NotImplementedError):
        ts.predict(make_batch(14, n=1), ids=["a"])
    with pytest.raises(NotImplementedError):
        ts.export(str(tmp_path / "x"), make_batch(14, n=1))
    with pytest.raises(NotImplementedError):
        tserve.Server(str(tmp_path), config=TConfig(small_cfg()),
                      device="cpu", shard=True)


def test_restore_without_checkpoint_fresh_inits(tmp_path):
    ts = tserve.Server(str(tmp_path / "none"), config=TConfig(small_cfg()),
                       device="cpu")
    assert ts.state["step"] == 0
    w = ts.state["params"]["net"]["query"][0]["w"]
    assert w.device.type == "cpu" and torch.isfinite(w).all()
    assert not os.path.exists(str(tmp_path / "none"))
