from setuptools import find_packages, setup

setup(
    name="traffic_env_tpu",
    version="0.1.0",
    description=("TPU-native multi-intersection traffic-light RL "
                 "framework (JAX/XLA)"),
    packages=find_packages(exclude=("tests",)),
    package_data={"traffic_env_tpu.runtime": ["traffic_native.cpp"],
                  "traffic_env_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                            "teachers/*.npz"]},
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy"],
    python_requires=">=3.10",
)
