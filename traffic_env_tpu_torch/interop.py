"""State carried across from the JAX package: its batched ``SimState``
leaves, as numpy arrays, to the port's state and back.

The JAX package holds a threefry ``key`` (2, B) per env where the port
holds a Philox ``seed`` (B,) and a reset counter ``resets`` (B,);
``sim_from_arrays`` takes ``seed`` when given and otherwise the first
key word's bits, and ``resets`` when given and otherwise 0.
``trip_hist`` (validate telemetry) is carried when present, and
``cars`` with all its rows: the compact state's x/v/w (and the
archetype-index row 3 of a k > 1 state), or the gather core's ten
parameter rows (``structs.init_state``, the JAX package's
``init_state``), so one JAX ``init_state``/``reset`` batch feeds both
packages.
``schedule_from_arrays`` carries a schedule, its ``aidx`` included.
``qnet_state_dict_from_flax`` and ``convqnet_state_dict_from_flax`` turn
a flax ``QNet`` or ``ConvQNet`` param tree into the port's state_dict,
and ``a3cnet_state_dict_from_flax`` and
``convgru_a3c_state_dict_from_flax`` an ``A3CNet`` or ``ConvGRUA3CNet``
tree, ``dueling_qrnn_state_dict_from_flax`` and
``polgrad_state_dict_from_flax`` a ``DuelingQRNN`` or ``PolGradNet`` tree.
These state dicts hold the whole parameters; a module split over mp
(``parallel.shard_params(module, "mp")``) loads them as they are, its
``load_state_dict`` slicing each whole tensor to the rank's part.
``load_teacher`` reads a distillation teacher: a ``.npz`` of a
flax ``QNet``/``ConvQNet`` tree (``convert_teachers.py`` writes the
repo's) or the port's own qlearn checkpoint directory.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .envs.structs import SimState, SpawnSchedule

_FIELDS = ("cars", "leading", "lastcar", "phase", "elapsed", "passed",
           "detected", "waiting", "passed_dst", "rewards", "steps",
           "global_tick", "spawn_gap", "spawn_backlog", "done")


def sim_from_arrays(arrays: dict, device="cuda") -> SimState:
    """Batched SimState leaves (numpy, trailing batch axis) -> SimState:
    the fields of either core's state, with ``seed`` or the JAX
    package's raw threefry ``key`` (2, B) (see the module docstring)."""
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
    resets = arrays.get("resets")
    out["resets"] = torch.tensor(
        np.zeros(seed.shape[-1:], np.int32) if resets is None
        else np.asarray(resets, np.int32), device=dev)
    if arrays.get("trip_hist") is not None:
        out["trip_hist"] = torch.tensor(
            np.asarray(arrays["trip_hist"], np.int32), device=dev)
    return SimState(**out)


def sim_to_arrays(sim: SimState) -> dict:
    """SimState -> dict of numpy arrays under the JAX package's field
    names (plus ``seed`` and ``resets``); ``trip_hist`` only when the
    state has one."""
    keys = _FIELDS + ("seed", "resets") + (
        ("trip_hist",) if sim.trip_hist is not None else ())
    return {k: getattr(sim, k).detach().cpu().numpy() for k in keys}


def schedule_from_arrays(sched, device="cuda") -> SpawnSchedule:
    """A batched schedule with numpy (or array-like) fields ``counts``
    (T, B), ``roads`` (T, K, B), ``base`` and ``aidx`` (T, K, B) or None
    -> SpawnSchedule on ``device``."""
    aidx = getattr(sched, "aidx", None)
    return SpawnSchedule.from_numpy(
        np.asarray(sched.counts), np.asarray(sched.roads),
        np.asarray(sched.base), device,
        aidx=None if aidx is None else np.asarray(aidx))


def _kernel(a) -> torch.Tensor:
    """A flax kernel as the torch layer's weight: Dense (in, out) ->
    (out, in), Conv (kh, kw, in, out) -> (out, in, kh, kw)."""
    a = np.asarray(a, np.float32)
    return torch.tensor(np.ascontiguousarray(
        a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)))


def qnet_state_dict_from_flax(params) -> dict:
    """A flax ``QNet`` param tree (``{"params": {"Dense_i": {"kernel",
    "bias"}}}``, numpy leaves) -> the port's ``QNet`` state_dict.  Flax
    ``Dense`` kernels are (in, out); ``nn.Linear.weight`` is (out, in)."""
    tree = params.get("params", params)
    out = {}
    for i in range(len(tree)):
        layer = tree[f"Dense_{i}"]
        out[f"dense.{i}.weight"] = _kernel(layer["kernel"])
        out[f"dense.{i}.bias"] = torch.tensor(
            np.asarray(layer["bias"], np.float32))
    return out


def convqnet_state_dict_from_flax(params) -> dict:
    """A flax ``ConvQNet`` param tree (``{"params": {"Conv_i": {"kernel",
    "bias"}}}``, numpy leaves) -> the port's ``ConvQNet`` state_dict.
    Flax ``Conv`` kernels are (kh, kw, in, out); ``nn.Conv2d.weight`` is
    (out, in, kh, kw)."""
    tree = params.get("params", params)
    out = {}
    for i in range(len(tree)):
        layer = tree[f"Conv_{i}"]
        out[f"conv.{i}.weight"] = _kernel(layer["kernel"])
        out[f"conv.{i}.bias"] = torch.tensor(
            np.asarray(layer["bias"], np.float32))
    return out


def _named_state_dict_from_flax(params) -> dict:
    """A flax param tree whose module names are the torch module's
    attribute names -> that module's state_dict: ``a/b/kernel`` becomes
    ``a.b.weight`` (transposed), ``a/b/bias`` ``a.b.bias``."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            elif k == "kernel":
                out[".".join(prefix + ("weight",))] = _kernel(v)
            else:
                out[".".join(prefix + (k,))] = torch.tensor(
                    np.asarray(v, np.float32))

    walk(params.get("params", params), ())
    return out


def a3cnet_state_dict_from_flax(params) -> dict:
    """A flax ``A3CNet`` tree (``Dense_0``, ``GRUCell_0`` with ``ir``,
    ``iz``, ``in``, ``hr``, ``hz``, ``hn``, ``Dense_1``, ``score_layer``,
    ``value_layer``) -> the port's ``A3CNet`` state_dict."""
    return _named_state_dict_from_flax(params)


def convgru_a3c_state_dict_from_flax(params) -> dict:
    """A flax ``ConvGRUA3CNet`` tree (``ConvGRUCell_0`` with
    ``update_gate``, ``reset_gate``, ``candidate``; ``score_head``,
    ``value_head``) -> the port's ``ConvGRUA3CNet`` state_dict."""
    return _named_state_dict_from_flax(params)


def dueling_qrnn_state_dict_from_flax(params) -> dict:
    """A flax ``DuelingQRNN`` tree (``Dense_0``, ``GRUCell_0``,
    ``Dense_1``, the advantage head ``Dense_2``, the value head
    ``Dense_3``) -> the port's ``DuelingQRNN`` state_dict."""
    return _named_state_dict_from_flax(params)


def polgrad_state_dict_from_flax(params) -> dict:
    """A flax ``PolGradNet`` tree (``Dense_0``, ``GRUCell_0``,
    ``Dense_1``, ``Dense_2``, ``score_layer``) -> the port's
    ``PolGradNet`` state_dict."""
    return _named_state_dict_from_flax(params)


def _unflatten(flat: dict) -> dict:
    """{"a/b/c": array} -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def load_teacher(path: str, cfg, device="cuda"):
    """A distillation teacher in eval mode on ``device``: a ``QNet`` or,
    when its tree has ``Conv*`` layers, a ``ConvQNet`` on ``cfg``'s
    grid.  ``path`` is a ``.npz`` of a flax ``params_main`` tree (keys
    ``params/Dense_0/kernel`` ...), or a directory holding the port's
    qlearn checkpoint (``best.ckpt``, else ``model.ckpt``), whose
    ``main`` net it loads."""
    from .models.nets import ConvQNet, QNet
    from .utils.checkpoint import Checkpointer
    if os.path.isdir(path):
        ck = Checkpointer(path)
        ckpt = ck.latest_path("best.ckpt") or ck.latest_path("model.ckpt")
        if ckpt is None:
            raise FileNotFoundError(
                f"no port checkpoint (best.ckpt / model.ckpt) in {path}; "
                "a JAX package checkpoint converts with "
                "convert_teachers.py")
        sd = torch.load(ckpt, map_location="cpu", weights_only=True)["main"]
    else:
        with np.load(path) as z:
            tree = _unflatten({k: z[k] for k in z.files})
        conv = any(k.startswith("Conv") for k in tree["params"])
        sd = (convqnet_state_dict_from_flax if conv
              else qnet_state_dict_from_flax)(tree)
    conv = "conv.0.weight" in sd
    prefix = "conv" if conv else "dense"
    first, last = sd[f"{prefix}.0.weight"], sd[f"{prefix}.3.weight"]
    if conv:
        m, n = cfg.grid_m, cfg.grid_n
        net = ConvQNet(m, n, first.shape[1] * m * n, last.shape[0])
    else:
        net = QNet(first.shape[1], last.shape[0] // 2)
    net.load_state_dict(sd)
    return net.to(device).eval()
