#!/usr/bin/env python3
"""Convert the qlearn distillation teachers under ``teachers/`` (orbax
checkpoints of the JAX package) into ``.npz`` files that the PyTorch
port reads without JAX.

    JAX_PLATFORMS=cpu python convert_teachers.py [--out DIR] [NAME ...]

For each teacher ``teachers/<NAME>`` it restores the latest
``best.ckpt`` (else ``model.ckpt``) with the JAX package's
``Checkpointer`` and writes its ``params_main`` tree, every leaf as a
float32 array under a ``/``-joined key (``params/Dense_0/kernel``), to
``<DIR>/<NAME>.npz``; DIR defaults to
``traffic_env_tpu_torch/teachers``.  ``interop.load_teacher`` reads
these files.  Runs on the CPU in seconds.
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TEACHERS = ("qlearn_3x3_occ", "qlearn_5x5_conv_occ", "qlearn_5x5_occ")


def flatten(tree, prefix=()):
    """Nested dict of arrays -> {"a/b/c": float32 array}."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def restore_params(teacher_dir):
    """The ``params_main`` tree of the teacher's latest checkpoint."""
    from traffic_env_tpu.utils.checkpoint import Checkpointer
    ck = Checkpointer(teacher_dir)
    path = ck.latest_path("best.ckpt") or ck.latest_path("model.ckpt")
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {teacher_dir}")
    return ck._ck.restore(path)["params_main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=list(TEACHERS))
    ap.add_argument("--out", default=os.path.join(
        REPO, "traffic_env_tpu_torch", "teachers"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name in args.names:
        arrays = flatten(restore_params(os.path.join(REPO, "teachers", name)))
        path = os.path.join(args.out, f"{name}.npz")
        np.savez_compressed(path, **arrays)
        shapes = {k: v.shape for k, v in arrays.items()}
        print(f"{path}: {os.path.getsize(path)} bytes, {shapes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
