"""Learners and scripted baselines, dispatched by trainer name
(counterpart of ``traffic_env_tpu/algorithms/__init__.py``): qlearn,
qrnn, a3c, polgrad_rnn, cem and the six baselines."""

from __future__ import annotations

import importlib

import torch

from ..config import Config

_BASELINES = ("random", "const0", "const1", "fixed", "greedy",
              "spacedgreedy")
_PORTED = ("qlearn", "qrnn", "a3c", "polgrad_rnn", "cem") + _BASELINES


def run_alg(cfg: Config):
    """Dispatch on --trainer."""
    name = cfg.trainer
    if cfg.num_processes > 1:
        raise NotImplementedError("multi-process training is not ported "
                                  "yet (ROADMAP queue 1, item 11)")
    if cfg.single_agent and name not in ("qlearn", "qrnn"):
        raise ValueError(
            "--single_agent flattens the action space to one 2^I-way "
            "head, which only the argmax learners (qlearn, qrnn) can "
            "express")
    if name not in _PORTED:
        raise ValueError(f"unknown trainer {name!r}; choose from "
                         f"{_PORTED}")
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
