"""The benchmark's command: one cell of ``BENCHMARK.json`` on the card.

    python3 bench/run.py --workload paper-usecase.sweep --seed 7 \\
        --seconds 40 --trace 0

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
the numbers compared beside their limits under ``checked``) and those
numbers last on standard error.  Exits non-zero with no result when no
CUDA device is present, when the port cannot be imported, or when JAX or
the JAX package was loaded.

The process runs with a fixed ``PYTHONHASHSEED`` (it starts itself again
with one when it has none), so that no two runs differ in their string
hashes; set-up is timed from the first start.
"""
import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HASH_SEED = "0"

if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != HASH_SEED:
    # perf_counter is the system's monotonic clock, the same in the new image
    env = dict(os.environ, PYTHONHASHSEED=HASH_SEED,
               BENCH_STARTED_AT=repr(STARTED))
    os.execve(sys.executable, [sys.executable] + sys.argv, env)

STARTED = float(os.environ.get("BENCH_STARTED_AT", STARTED))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
