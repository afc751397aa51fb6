"""Where collectives appear on the port's sharded path (the counterpart
of ``tests/test_collectives.py:68-160``), counted on gloo ranks on the
CPU.  Inside each rank function ``torch.distributed``'s ``all_reduce``,
``all_gather`` and ``broadcast`` are wrapped to record the op, the
ranks of its group and its bytes; the program is not changed.

* the window env's step issues no collective: each rank simulates its
  own envs;
* qlearn's agent steps all-reduce only the TD batch that
  ``replay._from_owners`` fills in (its bytes from the config) and the
  episode's mean reward, nothing parameter-sized;
* a3c's update all-reduces exactly its parameter bytes, each parameter
  once (``a3c.py:141-144``), plus the O(1) scalars of ``--norm_adv``
  (``a3c.py:136-137``) and of the statistics;
* under the mp split (``parallel.shard_params(net, "mp")``) every
  ``nn.Linear`` forward is one all-gather over the mp group and every
  backward that needs the input's gradient one all-reduce over it.
"""

import contextlib

import torch
import torch.distributed as tdist

from traffic_env_tpu_torch import parallel
from traffic_env_tpu_torch.algorithms import a3c, qlearn
from traffic_env_tpu_torch.algorithms.common import build_env
from traffic_env_tpu_torch.config import Config
from traffic_env_tpu_torch.models.nets import WIDTH, QNet

TIMEOUT_S = 120
# the JAX package's mesh test sizes (tests/test_torch_mesh_learners.py)
LEARNER = dict(grid_m=1, grid_n=2, road_length=60.0, num_envs=16,
               episode_secs=40, light_secs=5, buffer_size=32, batch_size=8,
               seed=0, platform="cpu")


def ranks(n, fn, *args, mesh_shape=""):
    return parallel.launch(fn, args, world_size=n, mesh_shape=mesh_shape,
                           timeout_s=TIMEOUT_S, threads=2)


@contextlib.contextmanager
def counted():
    """Within it, every ``all_reduce``, ``all_gather`` and ``broadcast``
    call is recorded in the list it yields as (op, the group's ranks,
    bytes of this rank's tensor)."""
    log, saved = [], {}

    def wrap(op, fn):
        def call(*args, **kw):
            t = args[1] if op == "all_gather" else args[0]
            group = kw.get("group")
            members = tuple(range(tdist.get_world_size())) if group is None \
                else tuple(tdist.get_process_group_ranks(group))
            log.append((op, members, t.numel() * t.element_size()))
            return fn(*args, **kw)
        return call

    for op in ("all_reduce", "all_gather", "broadcast"):
        saved[op] = getattr(tdist, op)
        setattr(tdist, op, wrap(op, saved[op]))
    try:
        yield log
    finally:
        for op, fn in saved.items():
            setattr(tdist, op, fn)


def env_steps(cfg, steps):
    """``steps`` lazy-autoreset window steps of this rank's envs after a
    reset, counted."""
    _, cfg, benv = build_env(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    env, _ = benv.reset(benv.init(gen))
    a = torch.ones((benv.n_intersections, benv.n_envs), dtype=torch.int32)
    with counted() as log:
        for _ in range(steps):
            env, _, _, _, _ = benv.step_autoreset_lazy(env, a)
    return log


def test_window_env_step_issues_no_collective():
    """Two ranks of the 3x3 window env, 8 envs each: 12 lazy-autoreset
    steps issue no collective at all."""
    cfg = Config(trainer="greedy", platform="cpu", grid_m=3, grid_n=3,
                 num_envs=16, episode_secs=60).derive()
    assert ranks(2, env_steps, cfg, 12) == []


def qlearn_episode(cfg):
    """One qlearn episode (the replay filling, then training), then a
    second, counted: (the log, TD steps of the counted episode, the
    TD batch's bytes from the config, the parameters' bytes)."""
    ctx, ts = qlearn.make_state(cfg)
    ctx.fns.run_episode(ts)
    before = ts.train_steps
    with counted() as log:
        ctx.fns.run_episode(ts)
    benv = ctx.benv
    # frames (batch, k + 1, obs), a (batch, I), r (batch, I), nd (batch, 1)
    words = cfg.batch_size * ((cfg.history + 1) * benv.obs_dim
                              + 2 * benv.n_intersections + 1)
    params = sum(p.numel() * 4 for p in ts.main.parameters())
    return log, ts.train_steps - before, 4 * words, params


def test_qlearn_all_reduces_only_the_td_batch():
    """qlearn on 2 ranks at the JAX package's mesh test sizes: a
    training episode issues one all-reduce of the TD batch a train step
    (``replay._from_owners``, its bytes from batch size, history, obs
    width and intersections) and one of the mean reward (4 bytes), all
    over both ranks; nothing parameter-sized."""
    cfg = Config(trainer="qlearn", **LEARNER).derive()
    log, steps, td_bytes, param_bytes = ranks(2, qlearn_episode, cfg)
    assert steps == cfg.episode_len
    assert sorted(log) == sorted(
        [("all_reduce", (0, 1), td_bytes)] * steps
        + [("all_reduce", (0, 1), 4)])
    assert td_bytes < 0.2 * param_bytes


def a3c_window(cfg):
    """One a3c window (rollout and update) after make_state, counted:
    (the log, each parameter's bytes in order)."""
    ctx, ts = a3c.make_state(cfg)
    with counted() as log:
        ctx.fns.run_window(ts)
    return log, [p.numel() * 4 for p in ts.net.parameters()]


def test_a3c_all_reduces_its_parameters_once():
    """a3c with --norm_adv on 2 ranks: one window's all-reduces are
    each parameter's gradient once, in parameter order (together the
    parameter bytes, as the JAX package's one fused psum), and the two
    scalars of the advantage's mean and variance; nothing else."""
    cfg = Config(trainer="a3c", norm_adv=True, **LEARNER).derive()
    log, sizes = ranks(2, a3c_window, cfg)
    assert all(op == "all_reduce" and group == (0, 1)
               for op, group, _ in log)
    big = [b for _, _, b in log if b > 4]
    assert big == sizes
    assert [b for _, _, b in log if b <= 4] == [4, 4]


def mp_counts(cfg):
    """On a mesh with mp: a QNet split on mp, its forward without and
    with the input's gradient and both backward passes, each counted;
    then qlearn with main, chooser and target split, one TD step
    counted after an episode."""
    net = parallel.shard_params(QNet(40, 2), "mp")
    x = torch.ones(8, 40)
    out = {}
    for name, x in (("no_dx", x), ("dx", x.clone().requires_grad_(True))):
        with counted() as fwd:
            q = net(x)
        with counted() as bwd:
            q.sum().backward()
        out[name] = (fwd, bwd)
    ctx, ts = qlearn.make_state(cfg)
    for n in (ts.main, ts.chooser, ts.target):
        parallel.shard_params(n, "mp")
    ctx.fns.run_episode(ts)
    batch = ts.replay.sample(ts.generator, cfg.batch_size)
    with counted() as td:
        ctx.fns.td_update(ts, batch)
    out["td"] = td
    return out


def test_mp_split_gathers_each_linear_once():
    """A 2 x 2 mesh, rank 0 (its mp group ranks 0 and 1, its dp group
    ranks 0 and 2).  QNet (4 Linears) split on mp: the forward is 4
    all-gathers over the mp group of the local outputs (batch x half
    the width), the backward 3 all-reduces of the input gradients of
    Linears 2-4 (batch x 200), and a fourth for Linear 1 when the input
    needs its gradient.  A qlearn TD step with its nets split: 12
    all-gathers (chooser, target and main forwards), 3 input-gradient
    all-reduces and one of the 4 dense layers' 8 squared norms, all over
    mp; no collective over dp (the TD batch is sampled before it)."""
    cfg = Config(trainer="qlearn", **LEARNER).derive()
    out = ranks(4, mp_counts, cfg, mesh_shape="2,2")
    mp = (0, 1)
    gathers = [("all_gather", mp, 8 * n * 4) for n in (100, 100, 100, 2)]
    reduces = [("all_reduce", mp, 8 * WIDTH * 4)] * 3
    assert out["no_dx"] == (gathers, reduces)
    assert out["dx"] == (gathers, reduces + [("all_reduce", mp, 8 * 40 * 4)])
    td = out["td"]
    assert [e for e in td if e[0] == "all_gather"] == \
        [e for e in td if e[0] == "all_gather" and e[1] == mp]
    assert len([e for e in td if e[0] == "all_gather"]) == 12
    reduce = [e for e in td if e[0] == "all_reduce"]
    assert reduce == [("all_reduce", mp, 8 * WIDTH * 4)] * 3 \
        + [("all_reduce", mp, 8 * 4)]
