"""Learners, dispatched by trainer name (counterpart of
``traffic_env_tpu/algorithms/__init__.py``).  The port has qlearn; the
other learners and the scripted baselines are not ported yet and raise,
naming the ROADMAP item that brings each."""

from __future__ import annotations

import importlib

import torch

from ..config import Config

_PORTED = ("qlearn",)
# trainer -> ROADMAP queue 1 item that ports it
_NOT_PORTED = {"qrnn": 9, "a3c": 8, "polgrad_rnn": 9, "cem": 9,
               "random": 7, "const0": 7, "const1": 7, "fixed": 7,
               "greedy": 7, "spacedgreedy": 7}


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
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"trainer {name!r} is not ported yet (ROADMAP queue 1, item "
            f"{_NOT_PORTED[name]})")
    if name not in _PORTED:
        raise ValueError(f"unknown trainer {name!r}; choose from "
                         f"{_PORTED + tuple(_NOT_PORTED)}")
    if cfg.debug:
        # the JAX package traps NaNs inside its jitted programs; autograd's
        # anomaly mode raises on a NaN in a backward pass
        torch.autograd.set_detect_anomaly(True)
    mod = importlib.import_module(f"{__name__}.{name}")
    return mod.run(cfg.derive())


__all__ = ["run_alg"]
