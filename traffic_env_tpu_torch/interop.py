"""State carried across from the JAX package: its batched ``SimState``
leaves, as numpy arrays, to the port's state and back.

The JAX package holds a threefry ``key`` (2, B) per env where the port
holds a Philox ``seed`` (B,); ``sim_from_arrays`` takes ``seed`` when
given and otherwise the first key word's bits.  ``trip_hist`` (validate
telemetry) is carried when present.  ``qnet_state_dict_from_flax`` turns
a flax ``QNet`` param tree into the port's ``QNet`` state_dict.
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
    if arrays.get("trip_hist") is not None:
        out["trip_hist"] = torch.tensor(
            np.asarray(arrays["trip_hist"], np.int32), device=dev)
    return SimState(**out)


def sim_to_arrays(sim: SimState) -> dict:
    """SimState -> dict of numpy arrays under the JAX package's field
    names (plus ``seed``); ``trip_hist`` only when the state has one."""
    keys = _FIELDS + ("seed",) + (("trip_hist",) if sim.trip_hist is not None
                                  else ())
    return {k: getattr(sim, k).detach().cpu().numpy() for k in keys}


def qnet_state_dict_from_flax(params) -> dict:
    """A flax ``QNet`` param tree (``{"params": {"Dense_i": {"kernel",
    "bias"}}}``, numpy leaves) -> the port's ``QNet`` state_dict.  Flax
    ``Dense`` kernels are (in, out); ``nn.Linear.weight`` is (out, in)."""
    tree = params.get("params", params)
    out = {}
    for i in range(len(tree)):
        layer = tree[f"Dense_{i}"]
        out[f"dense.{i}.weight"] = torch.tensor(
            np.asarray(layer["kernel"], np.float32).T.copy())
        out[f"dense.{i}.bias"] = torch.tensor(
            np.asarray(layer["bias"], np.float32))
    return out
