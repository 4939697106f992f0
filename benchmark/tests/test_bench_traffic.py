"""The traffic generator: deterministic by seed, the counts the mixes
promise, and the same set of halo sizes for every seed."""

import numpy as np
import pytest

from benchmark import traffic


def test_same_seed_same_shells():
    mix = traffic.load("limber")
    a = traffic.make_shells(mix, 16, 2 ** 31 + 11)
    b = traffic.make_shells(mix, 16, 2 ** 31 + 11)
    for x, y in zip(a, b):
        for k in ("ra", "dec", "M", "z", "map"):
            np.testing.assert_array_equal(x[k], y[k])


def test_seeds_move_the_work_not_its_size():
    mix = traffic.load("limber")
    a = traffic.make_shells(mix, 16, 3)[0]
    b = traffic.make_shells(mix, 16, 2 ** 31 + 4)[0]
    assert not np.array_equal(a["ra"], b["ra"])
    np.testing.assert_allclose(np.sort(a["M"]), np.sort(b["M"]), rtol=1e-12)
    np.testing.assert_allclose(np.sort(a["z"]), np.sort(b["z"]), rtol=1e-12)


def test_limber_counts_and_ranges():
    mix = traffic.load("limber")
    shells = traffic.make_shells(mix, 16, 5)
    assert len(shells) == 4
    for s in shells:
        n = traffic.halo_count(s)
        assert 30000 < n < 200000                    # ~93k at 10^12.8
        assert s["z"].min() >= 0.10 and s["z"].max() <= 0.12
        assert s["M"].min() >= 10 ** 12.78 and s["M"].max() <= 10 ** 15.32
        assert (np.abs(s["dec"]) <= 90).all()
    # distinct shells
    assert not np.array_equal(shells[0]["ra"], shells[1]["ra"])


def test_maps_positive_at_the_nside():
    mix = traffic.load("limber")
    for s in traffic.make_shells(mix, 16, 6):
        assert s["map"].shape == (12 * 16 * 16,)
        assert (s["map"] > 0).all()
