"""Kernel K8 (FFTLog) past an FFT of 2^21 points: its plan and the sizing
of its device-memory slots, on the CPU (torch only).

A row whose FFT (M points: N for a power of two, Bluestein's least power
of two >= 2 N - 1 otherwise) does not fit shared memory runs on a slot of
device memory, 4 M doubles (6 M with Bluestein), one a block. The wrapper
takes as many slots as the rows, the kernel's block count and 9/10 of the
free memory allow (``ops.fftlog.fht_slots``) and raises MemoryError when
not one fits; past ``FHT_MAX_M`` (2^27, the longest FFT held against the
plain version on the card) it refuses from the shape alone. The card test
(tests/test_torch_cuda.py::test_fht_kernel) runs rows of 2^22 and 2^27
points, each a power of two and Bluestein, against the plain version.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread             # noqa: F401,E402

from baryonforge_torch.ops import fftlog                    # noqa: E402

# the H100's opt-in shared memory a block (bytes), and K8's block count of
# the device-memory route (kLongBlocks in csrc/fftlog.cu)
H100_SMEM = 232448
LONG_BLOCKS = 132
GIB = 1 << 30


@pytest.mark.parametrize("N,M,bluestein", [
    (1 << 22, 1 << 22, False), ((1 << 20) + 1, 1 << 22, True),
    ((1 << 21) + 1, 1 << 23, True), (1 << 26, 1 << 26, False),
    ((1 << 26) - 1, 1 << 27, True), (1 << 27, 1 << 27, False)])
def test_fht_plan_past_two_to_the_21(N, M, bluestein):
    """Past 2^21 points the plan is the device-memory route with the same
    M rule, up to FHT_MAX_M = 2^27."""
    assert fftlog.fht_plan(N, H100_SMEM) == (M, bluestein, False)
    assert M <= fftlog.FHT_MAX_M == 1 << 27


@pytest.mark.parametrize("B,M,bluestein,free,want", [
    (1, 1 << 22, False, 60 * GIB, 1),
    (200, 1 << 22, False, 60 * GIB, LONG_BLOCKS),
    (200, 1 << 22, True, 10 * GIB, 10 * GIB * 9 // 10 // (48 << 22)),
    (5, 1 << 27, False, 5 * GIB, 1),
    (5, 1 << 27, True, 7 * GIB, 1),
    (20, 8192, False, 1 * GIB, 20),
    (0, 8192, False, 1 * GIB, 1)])
def test_fht_slots_fit_the_free_memory(B, M, bluestein, free, want):
    """A slot a row, up to the kernel's blocks and 9/10 of the free memory
    (32 or 48 bytes a point); at least one block even without rows."""
    got = fftlog.fht_slots(B, M, bluestein, free, LONG_BLOCKS)
    assert got == want
    assert got * (6 if bluestein else 4) * M * 8 <= 0.9 * free


@pytest.mark.parametrize("M,bluestein,free", [
    (1 << 27, False, 4 * GIB), (1 << 27, True, 6 * GIB),
    (1 << 22, False, 100 << 20)])
def test_fht_slots_refuse_with_a_memory_reason(M, bluestein, free):
    with pytest.raises(MemoryError, match="device-memory slot"):
        fftlog.fht_slots(1, M, bluestein, free, LONG_BLOCKS)
