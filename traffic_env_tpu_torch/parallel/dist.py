"""The rank layout of a sharded run and its collectives (counterpart of
``traffic_env_tpu/parallel/mesh.py``) on ``torch.distributed``.

The JAX package trains over a device mesh ``(dp[, mp])``: the env batch
and the replay shard on ``dp`` and the partitioner all-reduces the
gradients.  Here every device of the mesh is one process, a *rank*, with
one card (NCCL), or on the CPU (gloo):

* ``--mesh_shape=N`` (or ``dp,mp``) alone starts the ranks as local
  processes (:func:`launch`); rank r uses ``cuda:r``.
* ``--num_processes=P --process_id=i --coordinator=host:port`` is one of
  P hosts, each running ``world / P`` local ranks; global rank ``i *
  (world / P) + local``, the rendezvous a TCP store at the coordinator.

Rank ``r`` is the mesh position ``(r // mp, r % mp)``.  The envs shard
on ``dp`` only: ranks that differ only in ``mp`` hold the same envs and,
unless ``parallel.shard_params(module, "mp")`` splits them (``mp.py``),
the same replicated parameters, as ``shard_train_state`` places them in
the JAX package.  The collectives of the env batch run over the ranks
of one ``mp`` index (the *dp group*); those of the mp split over the
ranks of one ``dp`` index (the *mp group*, ranks ``d * mp .. d * mp +
mp - 1``), ``mp_all_gather`` and ``mp_all_reduce``.  At world 1 (no
process group) every helper returns its input: an unsharded run does
not change.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
from typing import Callable

import torch
import torch.distributed as tdist

# a rank that waits in a collective for longer than this raises
TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class _World:
    size: int = 1
    rank: int = 0
    dp: int = 1
    mp: int = 1
    device: torch.device | None = None
    group: object = None        # this rank's dp group; None: the world
    mp_group: object = None     # this rank's mp group; None: mp is 1


# The layout of this process's rank, set by distributed_init: one per
# process, as torch.distributed's own default group.
_WORLD = _World()


def mesh_dims(mesh_shape: str) -> tuple[int, int]:
    """``"N"`` -> (N, 1), ``"dp,mp"`` -> (dp, mp), ``""`` -> (1, 1)."""
    dims = tuple(int(x) for x in mesh_shape.split(",")) if mesh_shape \
        else (1,)
    if not 1 <= len(dims) <= 2 or min(dims) < 1:
        raise ValueError(f"--mesh_shape={mesh_shape!r}: give N or dp,mp "
                         "with positive sizes")
    return dims[0], dims[1] if len(dims) == 2 else 1


def world() -> int:
    """Ranks in the run (1 when unsharded)."""
    return _WORLD.size


def rank() -> int:
    return _WORLD.rank


def dp_rank() -> int:
    """This rank's index on the dp axis: its shard of the envs."""
    return _WORLD.rank // _WORLD.mp


def dp_size() -> int:
    return _WORLD.dp


def mp_rank() -> int:
    """This rank's index on the mp axis: its part of a split layer."""
    return _WORLD.rank % _WORLD.mp


def mp_size() -> int:
    return _WORLD.mp


def is_primary() -> bool:
    """Rank 0 owns the logdir: settings, metrics, checkpoints."""
    return _WORLD.rank == 0


def device() -> torch.device | None:
    """This rank's device, or None outside a sharded run."""
    return _WORLD.device


def env_slice(n_envs: int) -> tuple[int, int]:
    """(env_base, n_local): this rank's shard of ``n_envs`` global envs,
    envs ``env_base .. env_base + n_local - 1``.  Raises when the envs
    do not divide over dp."""
    dp = _WORLD.dp
    if n_envs % dp:
        raise ValueError(f"--num_envs={n_envs} must divide over the dp "
                         f"axis ({dp} ranks)")
    n = n_envs // dp
    return dp_rank() * n, n


def _sharded() -> bool:
    return _WORLD.size > 1 and _WORLD.dp > 1


def all_reduce(tensors, op: str = "sum"):
    """Sum (or ``op="mean"``) each tensor over the dp group, in place;
    returns the list."""
    tensors = list(tensors)
    if not _sharded():
        return tensors
    for t in tensors:
        tdist.all_reduce(t, group=_WORLD.group)
        if op == "mean":
            t.div_(_WORLD.dp)
        elif op != "sum":
            raise ValueError(f"op={op!r}: sum or mean")
    return tensors


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` summed over the dp group."""
    if not _sharded():
        return t
    return all_reduce([t.clone()])[0]


def all_gather(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The dp group's tensors concatenated along ``dim`` in dp order:
    the global batch from each rank's shard (``dim=-1`` for the
    batch-trailing env state, 0 for batch-first rows)."""
    if not _sharded():
        return t
    if t.dtype == torch.bool:
        return all_gather(t.view(torch.uint8), dim).view(torch.bool)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_WORLD.dp)]
    tdist.all_gather(parts, t, group=_WORLD.group)
    return torch.cat(parts, dim)


def _mp_split() -> bool:
    return _WORLD.size > 1 and _WORLD.mp > 1


def mp_all_gather(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The mp group's tensors concatenated along ``dim`` in mp order: a
    split layer's whole output (``dim=-1``) or weight (``dim=0``)."""
    if not _mp_split():
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_WORLD.mp)]
    tdist.all_gather(parts, t, group=_WORLD.mp_group)
    return torch.cat(parts, dim)


def mp_all_reduce(tensors):
    """Sum each tensor over the mp group, in place; returns the list."""
    tensors = list(tensors)
    if not _mp_split():
        return tensors
    for t in tensors:
        tdist.all_reduce(t, group=_WORLD.mp_group)
    return tensors


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if _WORLD.size == 1:
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src)
    return box[0]


def shard(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's part of a global tensor: its dp shard along ``dim``
    (the inverse of :func:`all_gather`)."""
    if not _sharded():
        return t
    n = t.shape[dim] // _WORLD.dp
    return t.narrow(dim, dp_rank() * n, n).clone()


def distributed_init(world_size: int, rank_: int, mesh_shape: str = "",
                     backend: str = "gloo", init_method: str = "",
                     dev=None, timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group of ``world_size`` ranks as ``rank_`` and
    record the layout: dp x mp from ``mesh_shape`` (all ranks on dp when
    empty), the rank's device ``dev`` (made current on the card), its dp
    group and its mp group.  ``init_method`` is ``tcp://host:port``."""
    global _WORLD
    dp, mp = mesh_dims(mesh_shape) if mesh_shape else (world_size, 1)
    if dp * mp != world_size:
        raise ValueError(f"mesh {dp}x{mp} does not have {world_size} ranks")
    dev = torch.device(dev) if dev is not None else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        backend, init_method=init_method, world_size=world_size,
        rank=rank_, timeout=datetime.timedelta(seconds=timeout_s))
    group = mp_group = None
    if mp > 1:
        # every rank makes every group, in the same order (NCCL waits
        # otherwise): the dp groups, then the mp groups
        for m in range(mp):
            g = tdist.new_group([d * mp + m for d in range(dp)])
            if rank_ % mp == m:
                group = g
        for d in range(dp):
            g = tdist.new_group([d * mp + m for m in range(mp)])
            if rank_ // mp == d:
                mp_group = g
    _WORLD = _World(size=world_size, rank=rank_, dp=dp, mp=mp, device=dev,
                    group=group, mp_group=mp_group)


def shutdown() -> None:
    """Leave the process group; the layout is world 1 again."""
    global _WORLD
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _WORLD = _World()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, world_size, rank_, mesh_shape, backend,
               init_method, dev, timeout_s, threads):
    """One rank: join, run ``fn(*args)`` with ``threads`` torch threads
    (when given), leave."""
    before = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    distributed_init(world_size, rank_, mesh_shape, backend, init_method,
                     dev, timeout_s)
    try:
        return fn(*args)
    finally:
        shutdown()
        torch.set_num_threads(before)


def _worker(*rank_args):
    """A spawned rank: ``_rank_main`` with stdout dropped (rank 0 prints
    the run's statistics); an exception prints its traceback and exits
    the process with code 1."""
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        _rank_main(*rank_args)


def launch(fn: Callable, args: tuple = (), world_size: int = 1,
           mesh_shape: str = "", backend: str = "gloo",
           device_type: str = "cpu", num_processes: int = 1,
           process_id: int = 0, coordinator: str = "",
           share_card: bool = False, timeout_s: float = TIMEOUT_S,
           threads: int | None = None):
    """Run ``fn(*args)`` on every local rank of a ``world_size``-rank run
    and return local rank 0's result.  This process is local rank 0; the
    others are new processes (``torch.multiprocessing``, spawn), so
    ``fn`` and ``args`` must pickle.  Of ``num_processes`` hosts this is
    ``process_id`` with ``world_size / num_processes`` local ranks, and
    the rendezvous is ``coordinator`` (host:port); one host takes a
    free localhost port.  On ``device_type="cuda"`` local rank r uses
    ``cuda:r`` (every rank ``cuda:0`` with ``share_card``, which only
    gloo takes) and there must be a card for every local rank: ranks
    are never doubled up on a card unasked.  ``threads`` caps each
    rank's torch threads (CPU ranks share the host's cores)."""
    P = max(int(num_processes), 1)
    if world_size % P:
        raise ValueError(f"{world_size} ranks do not divide over {P} "
                         "processes")
    local = world_size // P
    if device_type == "cuda":
        if share_card and backend == "nccl":
            raise ValueError("NCCL takes one card a rank; share a card "
                             "with gloo only")
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        need = 1 if share_card else local
        if n_cards < need:
            raise RuntimeError(f"{local} local ranks need {need} CUDA "
                               f"cards, found {n_cards}; run with "
                               "--platform=cpu for gloo on the CPU")
    elif device_type != "cpu":
        raise ValueError(f"device_type={device_type!r}: cpu or cuda")
    if P > 1:
        if not coordinator:
            raise ValueError("--num_processes > 1 needs --coordinator="
                             "host:port")
        init_method = f"tcp://{coordinator}"
    else:
        init_method = f"tcp://localhost:{free_port()}"

    def dev(lr):
        if device_type == "cpu":
            return "cpu"
        return "cuda:0" if share_card else f"cuda:{lr}"

    ctx = torch.multiprocessing.get_context("spawn")
    base = process_id * local
    procs = [ctx.Process(target=_worker, args=(
        fn, args, world_size, base + lr, mesh_shape, backend, init_method,
        dev(lr), timeout_s, threads), daemon=False)
        for lr in range(1, local)]
    for p in procs:
        p.start()
    ok = False
    try:
        out = _rank_main(fn, args, world_size, base, mesh_shape, backend,
                         init_method, dev(0), timeout_s, threads)
        ok = True
    finally:
        for p in procs:
            p.join(timeout=timeout_s if ok else 5.0)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [base + i + 1 for i, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} failed (see their tracebacks)")
    return out
