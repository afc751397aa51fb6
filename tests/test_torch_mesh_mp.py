"""The mp split of the dense layers on gloo ranks on the CPU
(``parallel.shard_params(module, "mp")``, the counterpart of
``traffic_env_tpu/parallel/mesh.py:135-150``): the column-parallel
``nn.Linear`` and ``QNet`` against the JAX package's under its
``shard_params`` on a (1, 2) mesh of virtual CPU devices; every net of
the port split on 2 ranks against the unsplit net (outputs and
gradients); ``ValueError`` where the JAX package's ``device_put`` raises;
a qlearn episode on a 2 x 2 mesh with main, chooser and target split
(the counterpart of ``tests/test_sharding.py:54-73``) against the
unsharded episode; and its checkpoint, which holds the whole parameters,
restored in one process and into a split run.  Ranks and the
one-process references run at 2 torch threads each, as in
``tests/test_torch_mesh_learners.py``."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.sharding import Mesh

from traffic_env_tpu.models import nets as jnets
from traffic_env_tpu.parallel import shard_params as jax_shard_params
from traffic_env_tpu_torch import interop, parallel
from traffic_env_tpu_torch.algorithms import qlearn
from traffic_env_tpu_torch.config import Config
from traffic_env_tpu_torch.models import nets
from traffic_env_tpu_torch.parallel.mp import ColumnParallelLinear
from traffic_env_tpu_torch.utils.checkpoint import Checkpointer

TIMEOUT_S = 120
# the JAX package's mesh test sizes (tests/test_torch_mesh_learners.py)
LEARNER = dict(trainer="qlearn", grid_m=1, grid_n=2, road_length=60.0,
               num_envs=16, episode_secs=40, light_secs=5, buffer_size=32,
               batch_size=8, seed=0, platform="cpu")
B, T = 8, 3


def ranks(n, fn, *args, mesh_shape=""):
    """``fn(*args)`` on ``n`` gloo ranks on the CPU at 2 torch threads
    each; rank 0's result."""
    return parallel.launch(fn, args, world_size=n, mesh_shape=mesh_shape,
                           timeout_s=TIMEOUT_S, threads=2)


# Each case: (flax module, its init input's shape, the port's state_dict
# converter, the port's module, the forward's input shapes).  The inputs
# of the recurrent nets are (obs (B, T, d), carry (B, hidden)).
CASES = {
    "linear": (lambda: fnn.Dense(18), (1, 40),
               lambda p: {"weight": torch.tensor(
                              p["params"]["kernel"].T.copy()),
                          "bias": torch.tensor(p["params"]["bias"])},
               lambda: torch.nn.Linear(40, 18), [(B, 40)]),
    "qnet": (lambda: jnets.QNet(n_actions=9), (1, 81),
             interop.qnet_state_dict_from_flax,
             lambda: nets.QNet(81, 9), [(B, 81)]),
    "qnet_single_agent": (lambda: jnets.QNet(n_actions=1, n_choices=16),
                          (1, 34), interop.qnet_state_dict_from_flax,
                          lambda: nets.QNet(34, 1, 16), [(B, 34)]),
    "dueling_qrnn": (lambda: jnets.DuelingQRNN(n_actions=9), (1, 1, 81),
                     interop.dueling_qrnn_state_dict_from_flax,
                     lambda: nets.DuelingQRNN(81, 9),
                     [(B, T, 81), (B, 220)]),
    "a3c_2x2": (lambda: jnets.A3CNet(n_actions=4, reward_size=4),
                (1, 1, 52), interop.a3cnet_state_dict_from_flax,
                lambda: nets.A3CNet(52, 4, 4), [(B, T, 52), (B, 160)]),
    "polgrad_2x2": (lambda: jnets.PolGradNet(n_actions=4), (1, 1, 52),
                    interop.polgrad_state_dict_from_flax,
                    lambda: nets.PolGradNet(52, 4), [(B, T, 52), (B, 250)]),
    "convq_3x3": (lambda: jnets.ConvQNet(m=3, n=3), (1, 81),
                  interop.convqnet_state_dict_from_flax,
                  lambda: nets.ConvQNet(3, 3, 81), [(B, 81)]),
    # the 9-wide score layer (and the 1-wide conv heads) do not divide
    "a3c_3x3": (lambda: jnets.A3CNet(n_actions=9, reward_size=9),
                (1, 1, 81), interop.a3cnet_state_dict_from_flax,
                lambda: nets.A3CNet(81, 9, 9), [(B, T, 81), (B, 160)]),
    "polgrad_3x3": (lambda: jnets.PolGradNet(n_actions=9), (1, 1, 81),
                    interop.polgrad_state_dict_from_flax,
                    lambda: nets.PolGradNet(81, 9), [(B, T, 81), (B, 250)]),
    "conv_gru_a3c": (lambda: jnets.ConvGRUA3CNet(m=3, n=3), (1, 1, 81),
                     interop.convgru_a3c_state_dict_from_flax,
                     lambda: nets.ConvGRUA3CNet(3, 3, 81),
                     [(B, T, 81), (B, 32, 3, 3)]),
}
RAISES = {"a3c_3x3": "score_layer.weight", "polgrad_3x3":
          "score_layer.weight", "conv_gru_a3c": "score_head.bias"}


def flax_params(name):
    """The case's flax module and its params (numpy), from a seed."""
    module, shape = CASES[name][:2]
    module = module()
    params = module.init(jax.random.key(len(name)), jnp.zeros(shape))
    return module, jax.tree.map(np.asarray, params)


def case_inputs(name):
    rng = np.random.RandomState(len(name))
    return [rng.uniform(-1, 1, s).astype(np.float32)
            for s in CASES[name][4]]


def split_forward(sds, split):
    """Every case's port module from its converted flax params
    ``sds[name]``, split on mp when ``split`` (the whole params loaded
    after the split, sliced as ``interop`` params are): its outputs, the
    gradients of a fixed weighting of them (the split ones gathered over
    mp), the input's gradient and the local parameter shapes; or the
    ``ValueError``'s message."""
    out = {}
    for name, sd in sds.items():
        torch.manual_seed(0)
        net = CASES[name][3]()
        try:
            parallel.shard_params(net, "mp" if split else None)
        except ValueError as e:
            out[name] = str(e)
            continue
        net.load_state_dict(sd)
        xs = [torch.tensor(x) for x in case_inputs(name)]
        xs[0].requires_grad_(True)
        ys = net(*xs)
        ys = [ys] if torch.is_tensor(ys) else list(ys)
        loss = sum(torch.sum(y * torch.linspace(-1, 1, y.numel()).reshape(
            y.shape)) for y in ys)
        loss.backward()
        split_ids = {id(p) for m in net.modules()
                     if isinstance(m, ColumnParallelLinear)
                     for p in m.parameters(recurse=False)}
        grads = {k: parallel.mp_all_gather(p.grad, 0)
                 if id(p) in split_ids else p.grad
                 for k, p in net.named_parameters()}
        out[name] = ([y.detach() for y in ys], grads, xs[0].grad,
                     {k: tuple(p.shape) for k, p in net.named_parameters()},
                     parallel.full_state_dict(net))
    return out


@pytest.fixture(scope="module")
def runs():
    """The flax params of every case, and the port's forward on them
    unsplit (one process) and split over mp on 2 ranks (mesh 1 x 2)."""
    params = {name: flax_params(name) for name in CASES}
    sds = {name: CASES[name][2](p) for name, (_, p) in params.items()}
    return (params, ranks(1, split_forward, sds, False),
            ranks(2, split_forward, sds, True, mesh_shape="1,2"))


def jax_mesh():
    return Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("dp", "mp"))


@pytest.mark.parametrize("name", ["linear", "qnet"])
def test_column_parallel_forward_matches_jax_shard_params(runs, name):
    """nn.Linear (40 -> 18) and QNet at the JAX widths (200, 9 x 2
    outputs) split on 2 ranks: each rank holds half of every weight's
    rows and bias, and the output equals the JAX package's module on
    ``shard_params(mesh, params, "mp")`` over a (1, 2) mesh, from the
    same numpy params, within 1e-6 of max |Q|."""
    params, _, split = runs
    module, p = params[name]
    sharded = jax_shard_params(jax_mesh(), p, "mp")
    leaf = jax.tree.leaves(sharded)[0]
    assert len(leaf.sharding.device_set) == 2
    want = np.asarray(jax.jit(module.apply)(
        sharded, jnp.asarray(case_inputs(name)[0])))
    got, _, _, shapes, _ = split[name]
    for key, shape in shapes.items():
        full = p["params"] if name == "linear" else \
            p["params"][f"Dense_{key.split('.')[1]}"]
        kernel = full["kernel" if key.endswith("weight") else "bias"]
        assert shape[0] == kernel.shape[-1] // 2, key
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(set(CASES) - set(RAISES)))
def test_split_net_matches_the_unsplit_net(runs, name):
    """Every net of the port that divides at mp 2, split on 2 ranks,
    against the same net in one process: the outputs within 1e-6 of
    their largest element, the gradients of every parameter (gathered
    over mp) and of the input within 1e-5 of the largest element, and
    the gathered state dict equal to the loaded one bit for bit.  The
    conv net has no dense layer: it is not split and is bit-equal."""
    _, one, split = runs
    y1, g1, dx1, shapes1, sd1 = one[name]
    y2, g2, dx2, shapes2, sd2 = split[name]
    for a, b in zip(y1, y2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-6 * float(a.abs().max()))
    top = max(float(g.abs().max()) for g in g1.values())
    assert top > 0
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=0,
                                   atol=1e-5 * top, err_msg=k)
    np.testing.assert_allclose(dx2.numpy(), dx1.numpy(), rtol=0,
                               atol=1e-5 * float(dx1.abs().max()))
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k
    halved = [k for k in shapes1 if shapes2[k] != shapes1[k]]
    if name == "convq_3x3":
        assert not halved
        for a, b in zip(y1, y2):
            assert torch.equal(a, b)
    else:
        assert halved and all(shapes2[k][0] * 2 == shapes1[k][0]
                              for k in halved)


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_raises_where_the_jax_package_raises(runs, name):
    """shard_params at mp 2 raises ``ValueError`` naming the leaf
    exactly where the JAX package's ``shard_params`` on a (1, 2) mesh
    raises: A3CNet's and PolGradNet's 9-wide score layers on 3x3 and
    the conv-GRU a3c's 1-wide heads; the unsplit run never raises."""
    params, one, split = runs
    jax_raises = False
    try:
        jax_shard_params(jax_mesh(), params[name][1], "mp")
    except ValueError:
        jax_raises = True
    assert jax_raises == (name in RAISES)
    assert not isinstance(one[name], str)
    if name in RAISES:
        assert isinstance(split[name], str)
        assert split[name].startswith(RAISES[name]), split[name]
        assert "mp=2" in split[name]
    else:
        assert not isinstance(split[name], str)


def split_nets(ts):
    for net in (ts.main, ts.chooser, ts.target):
        parallel.shard_params(net, "mp")


def mp_episode(cfg, split, logdir=None):
    """Two qlearn episodes from make_state on this rank, the nets split
    on mp when ``split``: the statistics, the whole parameters, the
    mesh layout (dp rank, mp rank, an mp all-gather and all-reduce of
    the rank ids).  With ``logdir``: the checkpoint saved there, then
    restored into a fresh split state, whose gathered state is
    returned."""
    ctx, ts = qlearn.make_state(cfg)
    if split:
        split_nets(ts)
    stats = [ctx.fns.run_episode(ts) for _ in range(2)]
    r = torch.tensor([float(parallel.rank())])
    layout = (parallel.dp_rank(), parallel.mp_rank(), parallel.mp_size(),
              parallel.mp_all_gather(r, 0).tolist(),
              parallel.mp_all_reduce([r.clone()])[0].item())
    sd = ts.state_dict()
    restored = None
    if logdir is not None:
        ckpt = Checkpointer(logdir)
        ckpt.save(ts)
        _, fresh = qlearn.make_state(cfg)
        split_nets(fresh)
        # a copy: the state dict holds Adam's live step counts
        restored = copy.deepcopy(ckpt.restore(fresh).state_dict())
        # the restored split run trains on
        ctx.fns.run_episode(fresh)
    return stats, sd, layout, restored


@pytest.fixture(scope="module")
def qlearn_runs(tmp_path_factory):
    """The unsharded qlearn run and the 2 x 2 run with its nets split,
    which saves its checkpoint."""
    cfg = Config(**LEARNER).derive()
    logdir = str(tmp_path_factory.mktemp("mp_ckpt"))
    return (cfg, logdir, ranks(1, mp_episode, cfg, False),
            ranks(4, mp_episode, cfg, True, logdir, mesh_shape="2,2"))


def assert_params_close(a, b, lr):
    """Parameters within 2% of the learning rate (the split run's matrix
    products round otherwise, and Adam's step is about lr whatever the
    gradient's size, so a gradient off in sign or scale moves an element
    by about lr); Adam's moments, as the gradients they average, within
    1e-5 of their largest element."""
    for name in ("main", "chooser", "target"):
        for k in a[name]:
            np.testing.assert_allclose(b[name][k].numpy(),
                                       a[name][k].numpy(), rtol=0,
                                       atol=2e-2 * lr, err_msg=(name, k))
    for i, s in a["opt"]["state"].items():
        for k, v in s.items():
            np.testing.assert_allclose(
                b["opt"]["state"][i][k].numpy(), v.numpy(), rtol=0,
                atol=1e-5 * float(v.abs().max()), err_msg=(i, k))


def test_split_qlearn_episode_matches_the_unsharded_one(qlearn_runs):
    """The counterpart of ``tests/test_sharding.py:54-73``: qlearn on a
    2 x 2 mesh with main, chooser and target split on mp, two episodes
    at the JAX package's mesh test sizes, against one process: the
    statistics finite and within rtol 1e-5 of the unsharded run's, the
    train steps alike, the whole parameters of the three nets and
    Adam's moments within 2% of the learning rate (``assert_params_
    close``) and Adam's moments within 1e-5 of their largest element.
    Rank 0 sits at (dp 0, mp 0) of mp 2, and its mp group is
    ranks 0 and 1."""
    cfg, _, (s1, sd1, _, _), (s4, sd4, layout, _) = qlearn_runs
    assert layout == (0, 0, 2, [0.0, 1.0], 1.0)
    assert all(np.isfinite(s).all() for s in s4)
    np.testing.assert_allclose(np.asarray(s4), np.asarray(s1), rtol=1e-5,
                               atol=1e-7)
    assert sd4["train_steps"] == sd1["train_steps"] > 0
    for k in sd1["main"]:
        assert sd4["main"][k].shape == sd1["main"][k].shape
    assert_params_close(sd1, sd4, cfg.learning_rate)


def test_split_checkpoint_restores_in_one_process(qlearn_runs):
    """The 2 x 2 split run's checkpoint holds the whole parameters and
    Adam moments: it restores in one process into the unsplit nets,
    equal to what the split run gathered, and trains on; restored into
    a fresh split run, it gathers back to the same state."""
    cfg, logdir, _, (_, sd4, _, restored) = qlearn_runs
    ctx, ts = qlearn.make_state(cfg.replace(logdir=logdir))
    Checkpointer(logdir).restore(ts)
    sd = ts.state_dict()
    assert os.path.isfile(os.path.join(logdir, "model.ckpt"))
    for got in (sd, restored):
        for name in ("main", "chooser", "target"):
            for k, v in sd4[name].items():
                assert torch.equal(got[name][k], v), (name, k)
        for i, s in sd4["opt"]["state"].items():
            for k, v in s.items():
                assert torch.equal(got["opt"]["state"][i][k], v), (i, k)
    assert ts.train_steps == sd4["train_steps"]
    stats = ctx.fns.run_episode(ts)
    assert all(np.isfinite(stats))


def test_mp_helpers_return_their_input_at_world_1():
    """Outside a sharded run mp is 1: the collectives return their
    input and shard_params leaves the module as it is."""
    t = torch.arange(6.0).reshape(2, 3)
    assert parallel.mp_size() == 1 and parallel.mp_rank() == 0
    assert parallel.mp_all_gather(t) is t
    assert parallel.mp_all_reduce([t])[0] is t
    net = nets.QNet(12, 2)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    assert parallel.shard_params(net, "mp") is net
    assert all(type(m) is not ColumnParallelLinear for m in net.modules())
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k])
