"""The roofline counts on a tiny shell, and the trace's reduction."""

import math

import numpy as np
import torch

from benchmark import counts, trace
from benchmark.reference import healpix as hpx
from benchmark.shells import reference_halos
from benchmark.reference import cosmo_core

CFG = dict(cosmology=dict(Omega_m=0.3175, Omega_b=0.049, h=0.6711,
                          sigma8=0.82, n_s=0.9649, w0=-1.0),
           epsilon_max=10, nside=64,
           table=dict(N_samples_z=3, N_samples_Mass=12, N_samples_R=64),
           runner=dict(dtype="float32", regrid_dtype="float64"))


def _shell(n=30, seed=1):
    rng = np.random.default_rng(seed)
    return dict(ra=rng.uniform(0, 360, n),
                dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
                M=10 ** rng.uniform(13.5, 14.5, n), z=rng.uniform(0.1, 0.2, n))


def test_member_pixels_matches_a_brute_count():
    shell = _shell()
    cosmo = cosmo_core.cosmology_from_dict(CFG["cosmology"])
    h = reference_halos(cosmo, shell, CFG["epsilon_max"], "cpu")
    npix = hpx.npix(CFG["nside"])
    th, ph = hpx.pix2ang(CFG["nside"], torch.arange(npix, dtype=torch.int32))
    v = torch.stack([torch.sin(th) * torch.cos(ph),
                     torch.sin(th) * torch.sin(ph), torch.cos(th)], 1)
    c = torch.stack([torch.sin(h["theta"]) * torch.cos(h["phi"]),
                     torch.sin(h["theta"]) * torch.sin(h["phi"]),
                     torch.cos(h["theta"])], 1)
    inside = (v @ c.T) >= torch.cos(h["radius"])[None, :]
    brute = float(inside.sum())
    expected = counts.member_pixels(CFG, shell)
    assert abs(expected - brute) < 0.05 * brute
    # the distinct pixels touched: the union of the discs
    touched = float(inside.any(1).sum())
    assert abs(counts.touched_pixels(CFG, expected) - touched) < 0.15 * touched


def test_least_seconds_by_hand():
    # 3.35e9 bytes take 1 ms; 67e9 float32 operations take 1 ms
    assert math.isclose(counts.least_seconds(3.35e9, 0, "float32"), 1e-3)
    assert math.isclose(counts.least_seconds(0, 67e9, "float32"), 1e-3)
    assert math.isclose(counts.least_seconds(0, 34e9, "float64"), 1e-3)
    assert counts.least_seconds(3.35e9, 1e3, "float64") == 1e-3


def test_layer_work_by_hand():
    shell = _shell(n=10)
    npix = hpx.npix(CFG["nside"])
    members = 1000.0
    touched = counts.touched_pixels(CFG, members)
    assert 0 < touched < members
    b, ops, dt = counts.phase_a(CFG, shell, members)
    assert dt == "float32" and ops == members * counts.PHASE_A_OPS
    assert b == 10 * 32 + 3 * 12 * 64 * 4 + touched * 8
    b, ops, dt = counts.phase_b(CFG, shell, members)
    assert dt == "float64" and ops == npix * counts.PHASE_B_OPS
    assert b == touched * 8 + 2 * npix * 8
    b, ops, dt = counts.paint(CFG, shell, members)
    assert b == 10 * 32 + 3 * 12 * 64 * 4 + npix * 4
    assert ops == members * counts.PAINT_OPS


def test_union_and_gaps():
    busy, gaps = trace.union_gaps([(2, 4), (3, 6), (8, 9), (-5, 0)], 0, 10)
    assert busy == 5
    assert gaps == [(0, 2), (6, 8), (9, 10)]


def test_short_names():
    assert trace.short_name(
        "void (anonymous namespace)::tile_pairs_kernel<bf::Deposit<float> >"
        "(bf::Tiling, int, int const*)") == "tile_pairs_kernel"
    assert trace.short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"
    assert trace.short_name("void layout_kernel<double>(int)") == \
        "layout_kernel"


class _Ev:
    def __init__(self, name, dev, s, e):
        self._n, self._d, self._s, self._e = name, dev, s, e

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


class _Prof:
    def __init__(self, events):
        self.profiler = type("K", (), {})()
        self.profiler.kineto_results = type("R", (), {})()
        self.profiler.kineto_results.events = lambda: events


def test_reduce_a_small_timeline():
    ev = [_Ev("bench.window", "CPU", 0, 1000),
          _Ev("bench.process", "CPU", 100, 900),
          _Ev("bench.process", "CUDA", 100, 900),      # the span's copy
          _Ev("bench.runner_init", "CPU", 10, 90),
          _Ev("void ns::k<float>(int)", "CUDA", 200, 300),
          _Ev("void ns::k<float>(int)", "CUDA", 250, 400),
          _Ev("Memcpy DtoH (Device -> Pageable)", "CUDA", 800, 950),
          _Ev("aten::add", "CPU", 0, 50)]
    r = trace.reduce(_Prof(ev))
    assert math.isclose(r["window_s"], 1000e-9)
    assert math.isclose(r["busy_s"], 350e-9)
    assert math.isclose(r["op_seconds"]["k"], 250e-9)
    idle = dict(r["breakdown"]["idle_gaps"])
    # gaps 0-200 (midpoint 100: process), 400-800 (process), 950-1000
    assert math.isclose(idle["process"], 600e-9)
    assert math.isclose(idle["harness"], 50e-9)
    assert r["breakdown"]["device_ops"][0][0] == "k"
