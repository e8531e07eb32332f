"""nlt_tpu_torch's norms, BatchNorm statistics, dense layer and MLP
against nlt_tpu's on the same numpy inputs and params: every norm in
training mode (BatchNorm inside a collector) and inference mode, the
collector's recorded statistics and their EMA merge, dense with each
activation, and the MLP with and without skip concatenations."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlt_tpu.networks import elements as jel
from nlt_tpu.networks import get_network_class as jax_network_class
from nlt_tpu_torch.convert import params_from_jax
from nlt_tpu_torch.networks import elements as tel
from nlt_tpu_torch.networks import get_network_class as torch_network_class

# float32 elementwise math and sums over at most a few hundred terms.
TOL = 1e-5
# The EMA merge: two float32 products and a sum.
MERGE_TOL = 1e-6


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor)
                      else t, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _params(rng, c, bn_name=None):
    p = {"gamma": rng.uniform(0.5, 2, c), "beta": rng.standard_normal(c)}
    if bn_name is not None:
        p["moving_mean__" + bn_name] = rng.standard_normal(c)
        p["moving_var__" + bn_name] = rng.uniform(0.5, 2, c)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("kind", ["batch", "layer", "instance", "pixel"])
@pytest.mark.parametrize("training", [False, True])
def test_norm_matches(rng, kind, training):
    """Values and the gradient with respect to x and gamma/beta; BatchNorm
    in training mode normalizes by the batch's statistics and records
    them, in inference mode by the moving statistics."""
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 0.5).astype(np.float32)
    p = {} if kind == "pixel" else _params(
        rng, 6, "bn0" if kind == "batch" else None)
    jp, tp = _both(p)
    jlayer = jel.norm(kind, bn_name="bn0")
    tlayer = tel.norm(kind, bn_name="bn0")
    g = rng.uniform(-1, 1, x.shape).astype(np.float32)

    def jfn(params, x):
        return jnp.sum(jlayer.apply(params, x) * g)

    with jel.collect_bn_stats() if training else _null() as jtaps:
        want = jlayer.apply(jp, jnp.asarray(x))
    with jel.collect_bn_stats() if training else _null():
        jgrad = jax.grad(jfn, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    with tel.collect_bn_stats() if training else _null() as ttaps:
        got = tlayer.apply(tp, tx)
    (got * torch.from_numpy(g)).sum().backward()
    _close(got, want)
    _close(tx.grad, jgrad[1])
    for k in ("gamma", "beta"):
        if k in tp:
            _close(tp[k].grad, jgrad[0][k])
    if kind == "batch" and training:
        assert set(ttaps) == set(jtaps) == {"bn0"}
        for stat in ("mean", "var"):
            assert ttaps["bn0"][stat].dtype == torch.float32
            assert not ttaps["bn0"][stat].requires_grad
            _close(ttaps["bn0"][stat], jtaps["bn0"][stat])
    elif training:
        assert ttaps == {} and jtaps == {}


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_batch_norm_bfloat16_matches(rng):
    """BatchNorm in bf16, training and inference mode: both packages take
    the statistics in bf16 (float32 sums, one rounding) and record them
    as float32. A bf16 rounding (2^-8 relative) of the mean, the
    variance, x - mean and the product: 2^-6 of values of magnitude ~3;
    the recorded statistics are bf16 values themselves, so they agree
    to a bf16 rounding, 2^-7 relative."""
    x = (rng.standard_normal((2, 8, 8, 4)) * 2 + 0.5).astype(np.float32)
    jp, tp = _both(_params(rng, 4, "bn1"))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jl, tl = jel.norm("batch", bn_name="bn1"), tel.norm("batch",
                                                       bn_name="bn1")
    with jel.collect_bn_stats() as jtaps:
        want = jl.apply(jp, jx)
    with tel.collect_bn_stats() as ttaps:
        got = tl.apply(tp, tx)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), 2.0 ** -6)
    for stat in ("mean", "var"):
        np.testing.assert_allclose(_np(ttaps["bn1"][stat]),
                                   np.asarray(jtaps["bn1"][stat]),
                                   rtol=2.0 ** -7, atol=2.0 ** -7)
    _close(tl.apply(tp, tx), np.asarray(jl.apply(jp, jx), np.float32),
           2.0 ** -6)


def test_merge_bn_stats_matches(rng):
    """The EMA merge by key name over a nested tree: BN leaves move by
    (1 - m), the others (gamma, beta, conv weights, leaves of layers
    without taps) pass through; the default momentum is 0.99."""
    tree = {"net": {"query": [
        {"w": rng.standard_normal((2, 2, 3, 4)).astype(np.float32)},
        _params(rng, 4, "query_bn0"), _params(rng, 4, "query_bn1")]},
        "loss": {"0": {}}}
    taps = {"query_bn0": {"mean": rng.standard_normal(4),
                          "var": rng.uniform(0.1, 3, 4)}}
    taps = {n: {s: v.astype(np.float32) for s, v in t.items()}
            for n, t in taps.items()}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = params_from_jax(tree)
    for m in (None, 0.9):
        want = jel.merge_bn_stats(
            jtree, jax.tree_util.tree_map(jnp.asarray, taps), momentum=m)
        got = tel.merge_bn_stats(
            ttree, jax.tree_util.tree_map(torch.from_numpy, taps),
            momentum=m)
        assert jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, want)) == \
            jax.tree_util.tree_structure(jax.tree_util.tree_map(
                lambda t: t.numpy(), got))
        for g, w in zip(jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(lambda t: t.numpy(), got)),
                jax.tree_util.tree_leaves(want)):
            _close(g, w, MERGE_TOL)
        moved = got["net"]["query"][1]["moving_mean__query_bn0"]
        assert not torch.equal(moved, ttree["net"]["query"][1][
            "moving_mean__query_bn0"])
        assert torch.equal(got["net"]["query"][2]["moving_var__query_bn1"],
                           ttree["net"]["query"][2]["moving_var__query_bn1"])
    assert tel.merge_bn_stats(ttree, {}) is ttree


def test_bn_collector_is_thread_local_and_nests(rng):
    """A collector on one thread is not seen by another (trainvali places
    batches on a worker); nested collectors restore the outer one, and
    enabled=False restores the moving statistics inside."""
    x = torch.from_numpy(rng.standard_normal((2, 3, 3, 4)).astype(
        np.float32))
    layer = tel.norm("batch", bn_name="t")
    p = _both(_params(rng, 4, "t"))[1]
    seen = {}

    def other():
        seen["collecting"] = tel.collecting_bn_stats()
        seen["y"] = layer.apply(p, x)

    with tel.collect_bn_stats() as outer:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        with tel.collect_bn_stats(enabled=False) as none:
            assert none is None and not tel.collecting_bn_stats()
            y_moving = layer.apply(p, x)
        assert tel.collecting_bn_stats()
        layer.apply(p, x)
    assert not seen["collecting"] and set(outer) == {"t"}
    assert torch.equal(seen["y"], y_moving)
    assert not tel.collecting_bn_stats()


@pytest.mark.parametrize("activation", [None, "relu", "sigmoid", "tanh"])
def test_dense_matches(rng, activation):
    x = rng.standard_normal((4, 3, 7)).astype(np.float32)
    p = {"w": (rng.standard_normal((7, 5)) * 0.4).astype(np.float32),
         "b": (rng.standard_normal(5) * 0.1).astype(np.float32)}
    jp, tp = _both(p)
    want = jel.dense(5, activation).apply(jp, jnp.asarray(x))
    got = tel.dense(5, activation).apply(tp, torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got, want)
    with pytest.raises(NotImplementedError):
        tel.dense(5, "softmax")


def test_dense_init_is_glorot(rng):
    p, out = tel.dense(64, "relu").init(torch.Generator().manual_seed(0),
                                        192)
    limit = np.sqrt(6.0 / (192 + 64))
    assert out == 64 and p["w"].shape == (192, 64)
    assert float(p["w"].abs().max()) <= limit
    assert float(p["w"].abs().max()) > 0.9 * limit
    assert torch.equal(p["b"], torch.zeros(64))


@pytest.mark.parametrize("skip_at", [None, [1], [0, 2]])
def test_mlp_matches(rng, skip_at):
    """Widths the skips change come out of init as apply consumes them;
    the same (converted) params give the same outputs."""
    widths, acts = [8, 6, 5, 3], ["relu", "tanh", None, "sigmoid"]
    jnet = jax_network_class("mlp")(widths, act=acts, skip_at=skip_at)
    tnet = torch_network_class("mlp")(widths, act=acts, skip_at=skip_at)
    jparams, jout = jnet.init_params(jax.random.PRNGKey(0), 4)
    tparams, tout = tnet.init_params(torch.Generator().manual_seed(0), 4)
    assert tout == jout
    assert [p["w"].shape for p in tparams] == \
        [tuple(p["w"].shape) for p in jparams]
    x = rng.standard_normal((5, 4)).astype(np.float32)
    jparams = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.1)
        .astype(np.float32), jparams)
    want = jnet.apply(jax.tree_util.tree_map(jnp.asarray, jparams),
                      jnp.asarray(x))
    got = tnet.apply(params_from_jax({"net": jparams})["net"],
                     torch.from_numpy(x))
    assert got.shape == want.shape == (5, jout)
    _close(got, want)
    with pytest.raises(ValueError):
        torch_network_class("mlp")(widths, act=["relu"])
