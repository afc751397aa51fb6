"""The training and validation CLI: every Config field is a flag.

    python -m traffic_env_tpu_torch --trainer=qlearn [--mode=validate] ...

Runs on the CUDA card unless ``--platform=cpu`` is given.
"""

from .algorithms import run_alg
from .config import parse_flags

if __name__ == "__main__":
    run_alg(parse_flags())
