"""The NumPy oracle (counterpart of ``traffic_env_tpu/oracle/``): the
reference-semantics simulator ``OracleSim``, its wrapper stack
``OracleEnv`` and the arrival spawners."""

from .sim import OracleSim, idm_update, ring_next
from .spawners import PoissonSpawner, RegularSpawner
from .stack import OracleEnv

__all__ = ["OracleEnv", "OracleSim", "PoissonSpawner", "RegularSpawner",
           "idm_update", "ring_next"]
