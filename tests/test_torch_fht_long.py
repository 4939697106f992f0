"""Kernel K8 (FFTLog) past shared memory: its pass route on the CPU.

A row whose FFT (M points: N for a power of two, Bluestein's least power
of two >= 2 N - 1 otherwise) does not fit shared memory runs in passes over
device memory (``ops.fftlog.fht_plan``, ``fht_passes``): pass p runs DFTs
of R_p points down the columns of stride S_p (the product of the later
radices) and multiplies by the four-step twiddles; the last pass's radix is
the 4096 points a block holds, the others at most 1024. Its scratch is 16 M
bytes a row beside 16 M for Bluestein's chirp, as many rows at once as 9/10
of the free memory holds (``fht_slots``), and MemoryError is its only
refusal. Checked here: the plan and its pass counts past 2^21 (up to 2^30
and beyond), the slots, the launch counts, and the plain rendering of the
passes (``fht_pass_fft_plain``, ``fht_route_plain``), with the sub-FFTs
forced small so that M = 2^12 runs three passes: against ``torch.fft.fft``
to 1e-12 of the largest value, and the whole transform against the JAX
``fht`` at N <= 2048 to tests/test_torch_fftlog.py's tolerance (1e-12 of
the largest value). The card test (tests/test_torch_cuda.py::
test_fht_kernel) runs the kernel itself against its plain version.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

import jax.numpy as jnp                                     # noqa: E402

from baryonforge_tpu.ops import fftlog as jf                # noqa: E402
from baryonforge_torch.ops import fftlog                    # noqa: E402

from test_torch_integrate_interp import close               # noqa: E402

# the H100's opt-in shared memory a block (bytes)
H100_SMEM = 232448
GIB = 1 << 30
# the twiddles' scratch beside the rows (16 bytes a point of a block)
TW = 16 * fftlog.PASS_POINTS


@pytest.mark.parametrize("N,M,bluestein,passes", [
    (1 << 22, 1 << 22, False, (1024, 4096)),
    ((1 << 20) + 1, 1 << 22, True, (1024, 4096)),
    ((1 << 21) + 1, 1 << 23, True, (64, 32, 4096)),
    (1 << 26, 1 << 26, False, (128, 128, 4096)),
    ((1 << 26) - 1, 1 << 27, True, (256, 128, 4096)),
    (1 << 27, 1 << 27, False, (256, 128, 4096)),
    (1 << 28, 1 << 28, False, (256, 256, 4096)),
    ((1 << 27) - 1, 1 << 28, True, (256, 256, 4096)),
    (1 << 30, 1 << 30, False, (512, 512, 4096)),
    (1 << 33, 1 << 33, False, (128, 128, 128, 4096))])
def test_fht_plan_past_two_to_the_21(N, M, bluestein, passes):
    """Past 2^21 points the plan is the pass route with the same M rule,
    with no longest M: two passes up to 2^22, three up to 2^32, four
    beyond; the last radix 4096, the others at most 1024, as even as the
    split allows (the larger first), their product M."""
    plan = fftlog.fht_plan(N, H100_SMEM)
    assert plan == (M, bluestein, False, passes)
    assert fftlog.fht_passes(M) == passes
    assert math.prod(passes) == M and passes[-1] == fftlog.PASS_POINTS
    assert max(passes[:-1]) <= fftlog.PASS_COLUMN
    assert list(passes[:-1]) == sorted(passes[:-1], reverse=True)
    assert max(passes[:-1]) <= 2 * min(passes[:-1])
    assert len(passes) == 2 + (M > 1 << 22) + (M > 1 << 32)


@pytest.mark.parametrize("B,N,sms,route", [
    (132, 8192, 132, (8192, False, False, ())),
    (1000, 8192, 132, (8192, False, False, ())),
    (131, 8192, 132, (8192, False, False, (2, 4096))),
    (132, 8192, None, (8192, False, False, (2, 4096))),
    (200, 3000, 132, (8192, True, False, (2, 4096))),
    (200, 16384, 132, (16384, False, False, (4, 4096))),
    (1000, 4097, 132, (16384, True, False, (4, 4096))),
    (1000, 4096, 132, (4096, False, True, ())),
    (200, 100, 132, (256, True, True, ()))])
def test_fht_plan_many_rows(B, N, sms, route):
    """A batch of rows for every SM, each a power of two of at most
    ROWS_MAX_M = 8192 points, runs one block a row on device memory
    (passes ()); fewer rows, longer ones or Bluestein's, the passes; rows
    that fit shared memory stay there."""
    assert fftlog.fht_plan(N, H100_SMEM, B, sms) == route


@pytest.mark.parametrize("B,M,bluestein,free,want", [
    (200, 8192, False, 1 * GIB, 132), (200, 8192, True, 1 * GIB, 132),
    (140, 8192, True, 50 << 20, (45 << 20) // (48 * 8192)),
    (132, 4096, False, 1 * GIB, 132)])
def test_fht_slots_one_block_a_row(B, M, bluestein, free, want):
    """One block a row: a slot of 4 M doubles (6 M with Bluestein) a
    block, up to the kernel's 132 blocks and 9/10 of the free memory."""
    got = fftlog.fht_slots(B, M, bluestein, free, 0, 132)
    assert got == want
    assert got * (6 if bluestein else 4) * 8 * M <= 0.9 * free


@pytest.mark.parametrize("B,M,bluestein,free,fixed,want", [
    (1, 1 << 22, False, 60 * GIB, 0, 1),
    (200, 1 << 22, False, 60 * GIB, 0, 200),
    (200, 1 << 22, True, 10 * GIB, 0,
     (int(0.9 * 10 * GIB) - (64 << 20) - TW) // (64 << 20)),
    (5, 1 << 27, False, 5 * GIB, 0, 2),
    (5, 1 << 27, True, 7 * GIB, 0, 2),
    (20, 8192, False, 1 * GIB, 0, 20),
    (0, 8192, False, 1 * GIB, 0, 1),
    (1, 1 << 28, True, 70 * GIB, 4 * GIB, 1),
    (3, 1 << 30, False, 70 * GIB, 0, 3),
    (4, 1 << 30, False, 70 * GIB, 20 * GIB, 2)])
def test_fht_slots_fit_the_free_memory(B, M, bluestein, free, fixed, want):
    """A row of scratch for each row, up to 9/10 of the free memory after
    the call's own tensors and the shared scratch (16 bytes a point a row,
    16 M more with Bluestein, and the twiddles); at least one even without
    rows."""
    got = fftlog.fht_slots(B, M, bluestein, free, fixed)
    assert got == want
    assert (got * 16 * M + (16 * M if bluestein else 0) + TW + fixed
            <= 0.9 * free)


@pytest.mark.parametrize("M,bluestein,free,fixed", [
    (1 << 27, False, 2 * GIB, 0), (1 << 27, True, 4 * GIB, 0),
    (1 << 22, False, 64 << 20, 0), (1 << 30, False, 16 * GIB, 0),
    (1 << 22, False, 1 * GIB, 1 * GIB)])
def test_fht_slots_refuse_with_a_memory_reason(M, bluestein, free, fixed):
    with pytest.raises(MemoryError, match="device-memory scratch"):
        fftlog.fht_slots(1, M, bluestein, free, fixed)


@pytest.mark.parametrize("N,B,slots,want", [
    (1024, 20, 20, 1), (4096, 1, 1, 1),
    (1 << 22, 1, 1, 1 + 5), (1 << 28, 1, 1, 1 + 7),
    ((1 << 20) + 1, 1, 1, 1 + 2 + 9), ((1 << 27) - 1, 1, 1, 1 + 3 + 13),
    (8192, 200, 200, 1 + 5), (8192, 200, 64, 1 + 4 * 5),
    (4097, 10, 3, 1 + 2 + 4 * 9), (8192, 0, 1, 1), (4097, 0, 1, 1)])
def test_fht_launches(N, B, slots, want):
    """One launch in shared memory; on the passes the set-up, Bluestein's
    chirp spectrum (P passes, once a call) and, for each group of rows,
    2 P + 1 launches (4 P + 1 for Bluestein's two convolutions)."""
    assert fftlog.fht_launches(fftlog.fht_plan(N, H100_SMEM), B,
                               slots) == want


def _caps(M, points):
    return fftlog.fht_passes(M, points, min(points, fftlog.PASS_COLUMN))


@pytest.mark.parametrize("M,points", [
    (1 << 12, 16), (1 << 13, 16), (1 << 12, 4096), (1 << 14, 4096),
    (1 << 11, 64), (256, 16), (2, 16), (8, 2)])
def test_fht_pass_order_plain(M, points):
    """The forward passes leave frequency m at ``fht_positions(M,
    passes)[m]`` and the inverse passes take that order back: against
    torch.fft.fft (and M times the input) to 1e-12 of the largest value,
    on two complex rows. M 2^11 to 2^14 are Bluestein's M for N = 1000 to
    8000 as well as powers of two; with 16 points a block, 2^12 runs
    three passes and 2^13 four."""
    passes = _caps(M, points)
    assert math.prod(passes) == M
    if (M, points) == (1 << 12, 16):
        assert passes == (16, 16, 16)
    rng = np.random.default_rng(M + points)
    z = torch.as_tensor(rng.normal(size=(2, M))
                        + 1j * rng.normal(size=(2, M)))
    fwd = fftlog.fht_pass_fft_plain(z, passes)
    want = torch.fft.fft(z)
    pos = fftlog.fht_positions(M, passes)
    assert sorted(pos.tolist()) == list(range(M))
    tol = 1e-12 * want.abs().max().item()
    assert (fwd[..., pos] - want).abs().max().item() <= tol
    back = fftlog.fht_pass_fft_plain(fwd, passes, inverse=True)
    assert (back - M * z).abs().max().item() <= 1e-12 * M * z.abs().max()


@pytest.mark.parametrize("M,points", [
    (1 << 12, 16), (1 << 13, 16), (1 << 14, 4096), (16, 16), (2, 2)])
def test_fht_coeff_layout_covers_each_position_once(M, points):
    """The coefficient pass's threads: each takes a frequency m < M / 2 at
    a position whose last-pass digit is below half its radix (runs of
    neighbours), and the partner N - m (N / 2 for m = 0): together every
    position once."""
    passes = _caps(M, points)
    pos, m, partner = fftlog.fht_coeff_layout_plain(M, passes)
    assert torch.all(m < M // 2)
    where = fftlog.fht_positions(M, passes)
    assert torch.equal(where[m], pos)
    assert torch.equal(where[torch.where(m > 0, M - m, M // 2)], partner)
    assert sorted(torch.cat([pos, partner]).tolist()) == list(range(M))
    R = passes[-1]
    assert torch.all(pos % R < max(R // 2, 1))


@pytest.mark.parametrize("N,points", [(2048, 16), (1000, 16)])
@pytest.mark.parametrize("mu,q", [(0.5, -0.5), (0.0, -1.0)])
def test_fht_route_plain_matches_jax(N, points, mu, q):
    """The pass route's order of work (bias, forward passes, the
    coefficients at the coefficient pass's positions, inverse passes,
    unbias; Bluestein's two chirp convolutions) against the JAX ``fht``,
    two rows; (0, -1) puts q on a Gamma pole, nudged by both packages."""
    rng = np.random.default_rng(N + points)
    x = np.geomspace(1e-4, 1e3, N)
    a = np.exp(-x[None] * rng.uniform(0.5, 2.0, (2, 1))) * x ** 0.5
    plan = fftlog.fht_plan(N, 0, points=points,
                           column=min(points, fftlog.PASS_COLUMN))
    assert len(plan.passes) >= 2 and not plan.in_shared
    xt = torch.as_tensor(x)
    lx, ln_kcrc = fftlog._fht_grids(xt, 1.0)
    qs = fftlog._safe_q(mu, q)
    got = fftlog.fht_route_plain(torch.as_tensor(a), lx, mu, qs, ln_kcrc,
                                 plan.passes)
    for b in range(2):
        _, aj = jf.fht(jnp.asarray(x), jnp.asarray(a[b]), mu, q)
        close(got[b], aj)
