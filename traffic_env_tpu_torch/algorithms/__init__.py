"""Learners and scripted baselines, dispatched by trainer name
(counterpart of ``traffic_env_tpu/algorithms/__init__.py``): qlearn,
qrnn, a3c, polgrad_rnn, cem and the six baselines, unsharded or, with
``--mesh_shape`` or ``--num_processes``, on the ranks of a sharded run
(``parallel/dist.py``)."""

from __future__ import annotations

import importlib

import torch

from .. import parallel
from ..config import Config

_BASELINES = ("random", "const0", "const1", "fixed", "greedy",
              "spacedgreedy")
_PORTED = ("qlearn", "qrnn", "a3c", "polgrad_rnn", "cem") + _BASELINES


def run_alg(cfg: Config):
    """Dispatch on --trainer.  With --mesh_shape or --num_processes the
    run goes to every local rank, each with its shard of the envs, and
    rank 0's result is returned: the world is ``--mesh_shape``'s dp x mp
    (one rank a process when only --num_processes is given), NCCL with
    one card a rank unless ``--platform=cpu`` (gloo)."""
    name = cfg.trainer
    if cfg.single_agent and name not in ("qlearn", "qrnn"):
        raise ValueError(
            "--single_agent flattens the action space to one 2^I-way "
            "head, which only the argmax learners (qlearn, qrnn) can "
            "express")
    if name not in _PORTED:
        raise ValueError(f"unknown trainer {name!r}; choose from "
                         f"{_PORTED}")
    if cfg.env_name == "cartpole":
        # before any rank starts: the fixture runs on one rank
        from .common import check_cartpole
        check_cartpole(cfg)
    if not (cfg.mesh_shape or cfg.num_processes > 1):
        return _run(cfg)
    dp, mp = parallel.mesh_dims(cfg.mesh_shape) if cfg.mesh_shape \
        else (max(cfg.num_processes, 1), 1)
    cpu = cfg.platform == "cpu"
    return parallel.launch(
        _run, (cfg,), world_size=dp * mp, mesh_shape=f"{dp},{mp}",
        backend="gloo" if cpu else "nccl",
        device_type="cpu" if cpu else "cuda",
        num_processes=max(cfg.num_processes, 1),
        process_id=cfg.process_id, coordinator=cfg.coordinator)


def _run(cfg: Config):
    name = cfg.trainer
    if cfg.debug:
        # the JAX package traps NaNs inside its jitted programs; autograd's
        # anomaly mode raises on a NaN in a backward pass
        torch.autograd.set_detect_anomaly(True)
    if name in _BASELINES:
        from . import baselines
        return baselines.run(cfg, name)
    mod = importlib.import_module(f"{__name__}.{name}")
    return mod.run(cfg.derive())


__all__ = ["run_alg"]
