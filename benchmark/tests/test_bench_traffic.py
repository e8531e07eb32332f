"""The traffic generators are deterministic from the seed, and every
seed offers the same load."""

import numpy as np

from benchmark.harness import scene
from benchmark.loops import closed, open as open_loop, train


def test_scene_is_a_function_of_the_seed():
    a = scene.Scene(2 ** 40 + 7, "t", 16, 2, 4, True, 0.5, "cpu")
    b = scene.Scene(2 ** 40 + 7, "t", 16, 2, 4, True, 0.5, "cpu")
    c = scene.Scene(2 ** 40 + 8, "t", 16, 2, 4, True, 0.5, "cpu")
    for k in a.images:
        assert np.array_equal(a.images[k], b.images[k])
        assert not np.array_equal(a.images[k], c.images[k])
    assert np.array_equal(a.warp, b.warp)
    assert a.live == c.live    # the same disk for every seed


def test_example_fields_are_the_wire_format():
    s = scene.Scene(5, "t", 16, 2, 4, True, 0.5, "cpu")
    ex = s.example(3)
    assert set(ex) == {"base", "cvis", "lvis", "warp", "rgb", "rgb_camspc",
                       "nn_base", "nn_rgb", "nn_rgb_camspc"}
    for k, v in ex.items():
        assert v.dtype == (np.float16 if k == "warp" else np.uint8), k
        assert v.shape[:3] == (1, 16, 16)


def test_epoch_orders():
    a = train.epoch_order(99, 3, 252)
    assert np.array_equal(a, train.epoch_order(99, 3, 252))
    assert not np.array_equal(a, train.epoch_order(99, 4, 252))
    assert sorted(a) == list(range(252))


def test_open_loop_schedule_same_load_other_order():
    one = open_loop.schedule(2 ** 33 + 1, 180, 20, 1024, 1.0, 16)
    again = open_loop.schedule(2 ** 33 + 1, 180, 20, 1024, 1.0, 16)
    other = open_loop.schedule(2 ** 33 + 2, 180, 20, 1024, 1.0, 16)
    assert np.array_equal(one[0], again[0])
    assert np.array_equal(one[1], again[1]) and one[3] == again[3]
    # the same gaps and the same popularity counts, in another order
    gaps = [np.sort(np.diff(np.concatenate([[0], s[0]]))) for s in
            (one, other)]
    assert np.allclose(gaps[0], gaps[1])
    assert not np.array_equal(one[0], other[0])
    ranks = [np.sort(np.argsort(s[2])[s[1]]) for s in (one, other)]
    assert np.array_equal(ranks[0], ranks[1])
    assert len(one[0]) == 180 * 20 and one[0][-1] <= 20


def test_zipf_counts():
    counts = open_loop._zipf_counts(1024, 1.0, 3600)
    assert counts.sum() == 3600
    assert np.all(np.diff(counts) <= 0)


def test_closed_loop_ring():
    groups = list(range(0, 1024, 4))
    a, sa = closed.ring(7, groups, 8)
    b, sb = closed.ring(7, groups, 8)
    assert a == b and sa == sb and sorted(a) == groups and len(sa) == 8
