"""The benchmark of ``traffic_env_tpu_torch`` on the H100: cells named in
``BENCHMARK.json``, run by ``python3 benchmark/run.py``."""
