"""Run one benchmark cell once and print its result line::

    python3 benchmark/run.py --workload grid3x3-random-32k --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout.  The port builds its kernel with nvcc
into ``traffic_env_tpu_torch/_build/`` inside the checkout, named by a
hash of the source, so only a checkout's first run builds.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
