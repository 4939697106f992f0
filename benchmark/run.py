"""The benchmark's command: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the card(s) the cell asks
for. Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` (and with
``--trace 1`` ``breakdown``), and last ``checks``, each number compared
beside its limit; the same numbers are the last lines of standard error.
Exits non-zero, printing no result, without CUDA or the cards the cell
needs, or when a module of JAX or of the JAX package was loaded. Before
anything else it keeps freed host memory in the process's heap
(``keep_freed_memory``).
"""

import time

T0 = time.perf_counter()

import ctypes  # noqa: E402


def keep_freed_memory():
    """Have glibc's malloc serve every block from the process's heap and
    never give freed memory back, so that the program's large host
    temporaries (host prep's per-halo arrays, ~100 MB each on a Limber
    shell) reuse pages already faulted in. Under the defaults each block
    over 32 MB is mapped, faulted in page by page and unmapped again: on an
    8-core H100 host that took ~2 s of kernel time a Limber call, half the
    call, and its speed swung with the host's load. The same aim as the
    jemalloc or tcmalloc that PyTorch's tuning guide advises for host-heavy
    work. Returns whether the settings took (False off glibc)."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return False
    m_trim_threshold, m_top_pad, m_mmap_max = -1, -2, -4
    return all(libc.mallopt(k, v) == 1 for k, v in (
        (m_mmap_max, 0), (m_trim_threshold, 2 ** 31 - 1),
        (m_top_pad, 1 << 28)))


ALLOCATOR_SET = keep_freed_memory()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--timeline", default=None,
                   help="write the traced window's Chrome trace here")
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    manifest = harness.load_manifest()
    chips = int(harness.find_cell(manifest, args.workload)["chips"])
    print(f"freed host memory kept in the heap: {ALLOCATOR_SET}",
          file=sys.stderr)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              args.trace, t0=T0, device="cuda",
                              manifest=manifest, timeline=args.timeline)
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
