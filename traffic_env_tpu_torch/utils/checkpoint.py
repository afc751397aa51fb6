"""Checkpoint, restore and settings snapshots (counterpart of
``traffic_env_tpu/utils/checkpoint.py``).

A fresh run wipes the logdir and snapshots every flag to settings.json,
so an old run revalidates exactly even after defaults change;
model.ckpt is written every save_rate episodes and on exit, best.ckpt
on validation records, each with a ``<name>.latest`` pointer.  A
checkpoint is one ``torch.save`` file of the train state's
``state_dict()`` (params, optimizer, replay, env state, counters,
generator).  The JAX package's orbax schema migration is not ported.

On a sharded run (``parallel/dist.py``) every rank calls ``save`` and
``restore``: ``state_dict()`` gathers the global state on every rank
(the envs over dp; the parameters and Adam moments of nets split by
``parallel.shard_params(net, "mp")`` over mp) and rank 0 alone writes
it (the JAX package's process-0-owned checkpoint, which holds global
arrays); rank 0 reads a checkpoint and sends it to the others, each of
which loads its shard and its mp part, so a checkpoint restores under
any world size and mesh.
"""

from __future__ import annotations

import os
import shutil

import torch

from .. import parallel
from ..config import Config


def remkdir(d: str):
    if os.path.exists(d):
        shutil.rmtree(d)
    os.makedirs(d, exist_ok=True)


def snapshot_settings(cfg: Config, logdir: str):
    with open(os.path.join(logdir, "settings.json"), "w") as f:
        f.write(cfg.to_json())


def load_settings(logdir: str) -> Config:
    with open(os.path.join(logdir, "settings.json")) as f:
        return Config.from_json(f.read())


class Checkpointer:
    """model.ckpt / best.ckpt pair in the logdir.  A state is any object
    with ``state_dict()`` and ``load_state_dict(sd)``."""

    def __init__(self, logdir: str):
        self.logdir = os.path.abspath(logdir)

    def _path(self, name: str, step=None) -> str:
        sfx = f"-{int(step)}" if step is not None else ""
        return os.path.join(self.logdir, f"{name}{sfx}")

    def save(self, state, name: str = "model.ckpt", step=None):
        """Write ``state``'s global state dict; on a sharded run every
        rank gathers and rank 0 writes (the others return None)."""
        sd = state.state_dict()
        if not parallel.is_primary():
            return None
        path = self._path(name, step)
        tmp = path + ".tmp"
        torch.save(sd, tmp)
        os.replace(tmp, path)
        with open(os.path.join(self.logdir, f"{name}.latest"), "w") as f:
            f.write(os.path.basename(path))
        return path

    def latest_path(self, name: str = "model.ckpt"):
        ptr = os.path.join(self.logdir, f"{name}.latest")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return os.path.join(self.logdir, f.read().strip())

    def restore(self, template, name: str = "model.ckpt"):
        """Load the latest ``name`` checkpoint into ``template`` (its
        tensors land on the template's device) and return it; on a
        sharded run rank 0 reads it for every rank."""
        sd = None
        if parallel.is_primary():
            path = self.latest_path(name)
            if path is None:
                raise FileNotFoundError(f"no checkpoint '{name}' in "
                                        f"{self.logdir}")
            sd = torch.load(path, map_location="cpu", weights_only=True)
        template.load_state_dict(parallel.broadcast_object(sd))
        return template
