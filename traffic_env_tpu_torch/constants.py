"""Shared simulator constants: car-parameter layout and reward/light
tuning (the port's own copy of ``traffic_env_tpu/constants.py``)."""

import numpy as np

# Car-parameter row indices, param-major: position, speed, length, max
# accel, accel exponent, desired speed, comfortable braking, headway
# time, jam distance, spawn tick.
X, V, L, A, DELTA, V0, B, T, S0, W = range(10)
NPARAMS = 10

CAPACITY = 20          # ring slots per road incl. reserved mirror slot 0
RING = CAPACITY - 1    # usable ring slots (the ring modulus)
YELLOW_TICKS = 6
THRESH = np.float32(0.2)      # "waiting" speed threshold
DETECT_RANGE = np.float32(10.0)  # detector covers last 10 m of a road
PASSING_REWARD = np.float32(0.0)
OVERFLOW_PENALTY = np.float32(10.0)
EPS = np.float32(1e-8)

# The single car archetype.
ARCHETYPES = np.zeros((1, NPARAMS), dtype=np.float32)
ARCHETYPES[0, V] = 11.11
ARCHETYPES[0, A] = 3
ARCHETYPES[0, DELTA] = 4
ARCHETYPES[0, V0] = 13.89
ARCHETYPES[0, L] = 4
ARCHETYPES[0, B] = 6
ARCHETYPES[0, T] = 2
ARCHETYPES[0, S0] = 1
