"""State carried across from the JAX package: its batched ``SimState``
leaves, as numpy arrays, to the port's state and back.

The JAX package holds a threefry ``key`` (2, B) per env where the port
holds a Philox ``seed`` (B,); ``sim_from_arrays`` takes ``seed`` when
given and otherwise the first key word's bits.  ``trip_hist`` (validate
telemetry) is not carried.
"""

from __future__ import annotations

import numpy as np
import torch

from .envs.structs import SimState

_FIELDS = ("cars", "leading", "lastcar", "phase", "elapsed", "passed",
           "detected", "waiting", "passed_dst", "rewards", "steps",
           "global_tick", "spawn_gap", "spawn_backlog", "done")


def sim_from_arrays(arrays: dict, device="cuda") -> SimState:
    """Batched SimState leaves (numpy, trailing batch axis) -> SimState."""
    dev = torch.device(device)
    out = {}
    for k in _FIELDS:
        a = np.asarray(arrays[k])
        if a.dtype == np.bool_:
            dt = torch.bool
        elif a.dtype.kind == "f":
            dt = torch.float32
        else:
            dt = torch.int32
        # a copy: the port updates its state in place
        out[k] = torch.tensor(np.array(a), device=dev).to(dt)
    if "seed" in arrays:
        seed = np.asarray(arrays["seed"])
    else:
        seed = np.asarray(arrays["key"])[0]
    out["seed"] = torch.tensor(seed.astype(np.uint32).view(np.int32),
                               device=dev)
    return SimState(**out)


def sim_to_arrays(sim: SimState) -> dict:
    """SimState -> dict of numpy arrays under the JAX package's field
    names (plus ``seed``)."""
    return {k: getattr(sim, k).detach().cpu().numpy()
            for k in _FIELDS + ("seed",)}
