"""traffic_env_tpu_torch: the PyTorch and CUDA port of traffic_env_tpu.

The grid-road IDM traffic simulator, batched over thousands of lockstep
envs, with its light-period window as a hand-written CUDA kernel for
Hopper (``csrc/window.cu``) and that kernel's plain PyTorch version for
the CPU, and the qlearn trainer on top (``python -m
traffic_env_tpu_torch --trainer=qlearn``).  Imports torch and numpy
only; never jax, and nothing of the JAX package.
"""

from .config import Config, derive_spawn_rate
from .topology import GridRoad

__version__ = "0.1.0"
__all__ = ["Config", "GridRoad", "derive_spawn_rate", "__version__"]
