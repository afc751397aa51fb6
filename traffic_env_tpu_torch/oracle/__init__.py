"""The NumPy oracle's pieces that the port runs (counterpart of
``traffic_env_tpu/oracle/``): so far its arrival spawners."""

from .spawners import PoissonSpawner, RegularSpawner

__all__ = ["PoissonSpawner", "RegularSpawner"]
