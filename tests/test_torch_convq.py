"""``ConvQNet`` (``--conv_gru`` with qlearn) against the JAX package on
the CPU: the grid maps of ``obs_grid_channels``, the forward on weights
converted from flax, one double-DQN update, and the trainer end to end.
Each test states its tolerance."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from traffic_env_tpu.models.nets import ConvQNet as JConvQNet
from traffic_env_tpu.models.nets import obs_grid_channels as j_grid
from traffic_env_tpu_torch.algorithms import qlearn, run_alg
from traffic_env_tpu_torch.config import Config
from traffic_env_tpu_torch.interop import convqnet_state_dict_from_flax
from traffic_env_tpu_torch.models.nets import ConvQNet, obs_grid_channels

K = 20


@pytest.mark.parametrize("width,history,lead", [
    (9, 3, (5,)), (13, 3, (5,)), (13, 1, (2, 3)), (9, 20, (4,))])
def test_obs_grid_channels_matches_jax(width, history, lead):
    """Frames of 9 or 13 blocks (occupancy), several history frames,
    extra leading axes: exactly equal (it only moves values)."""
    m, n = 2, 3
    flat = np.random.RandomState(width + history).standard_normal(
        lead + (history * width * m * n,)).astype(np.float32)
    want = np.asarray(j_grid(jnp.asarray(flat), m, n))
    got = obs_grid_channels(torch.as_tensor(flat), m, n).numpy()
    assert got.shape == lead + (m, n, history * width)
    np.testing.assert_array_equal(got, want)


def test_obs_grid_channels_without_a_frame_width_is_zeros():
    """A width that is no multiple of 9 or 13 frames: 9 zero channels,
    as in the JAX package."""
    flat = np.ones((3, 50), np.float32)
    want = np.asarray(j_grid(jnp.asarray(flat), 2, 3))
    got = obs_grid_channels(torch.as_tensor(flat), 2, 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 2, 3, 9) and not got.any()


def flax_convq(m, n, obs_size, seed):
    net = JConvQNet(m=m, n=n)
    params = net.init(jax.random.key(seed), jnp.zeros((1, obs_size)))
    return net, jax.tree.map(np.asarray, params)


def port_convq(m, n, obs_size, params):
    net = ConvQNet(m, n, obs_size)
    net.load_state_dict(convqnet_state_dict_from_flax(params))
    return net


@pytest.mark.parametrize("m,n,width", [(2, 3, 13), (5, 5, 13), (5, 5, 9)])
def test_convqnet_matches_flax(m, n, width):
    """Forward of (16, 20 frames) observations on converted weights:
    within 1e-5 absolute of the flax net (float32 sums over 9 * C_in
    inputs in another order); the output is (B, m * n, 2)."""
    obs_size = K * width * m * n
    net, params = flax_convq(m, n, obs_size, m + n + width)
    obs = np.random.RandomState(m * n).uniform(
        -2, 10, (16, K, width * m * n)).astype(np.float32)
    want = np.asarray(net.apply(params, jnp.asarray(obs)))
    got = port_convq(m, n, obs_size, params)(
        torch.as_tensor(obs)).detach().numpy()
    assert got.shape == (16, m * n, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_convqnet_init_matches_flax_statistics():
    """The port's own init draws each kernel as flax does (lecun normal
    over kh * kw * C_in, truncated at 2 std; zero bias): every layer's
    std within 5% of the flax init's, its bias 0."""
    m, n, obs_size = 5, 5, K * 13 * 25
    _, params = flax_convq(m, n, obs_size, 0)
    g = torch.Generator()
    g.manual_seed(0)
    net = ConvQNet(m, n, obs_size, generator=g)
    for i, layer in enumerate(net.conv):
        want = float(np.std(params["params"][f"Conv_{i}"]["kernel"]))
        assert abs(float(layer.weight.detach().std()) / want - 1) < 0.05
        assert not layer.bias.detach().any()


def test_conv_td_update_matches_optax():
    """One double-DQN update of ConvQNet (2x3 grid, 13-channel frames,
    batch 30, rewards scaled so the global-norm clip at 10 binds) from
    converted params, as tests/test_torch_qlearn.py holds QNet's: the
    loss within 1e-5 relative, every param whose clipped gradient is
    at least 1e-6 within 1e-5 of optax's, every other param within
    Adam's bound of lr per step."""
    m, n, width, B = 2, 3, 13, 30
    obs_size = K * width * m * n
    cfg = Config(trainer="qlearn", grid_m=m, grid_n=n, conv_gru=True,
                 learning_rate=2.5e-4).derive()
    jnet, params = flax_convq(m, n, obs_size, 4)
    rng = np.random.RandomState(5)
    s = rng.uniform(0, 5, (B, K, width * m * n)).astype(np.float32)
    s1 = rng.uniform(0, 5, (B, K, width * m * n)).astype(np.float32)
    a = rng.randint(2, size=(B, m * n)).astype(np.int32)
    r = (rng.standard_normal((B, m * n)) * 100).astype(np.float32)
    nd = (rng.rand(B, 1) > 0.1).astype(np.float32)

    p = jax.tree.map(jnp.asarray, params)
    greedy1 = jnp.argmax(jnet.apply(p, s1), axis=-1)
    next_q = jnp.take_along_axis(jnet.apply(p, s1), greedy1[..., None],
                                 -1)[..., 0]
    target = r + cfg.gamma * nd * next_q

    def loss_fn(pm):
        pred = jnp.take_along_axis(jnet.apply(pm, s), a[..., None],
                                   -1)[..., 0]
        return jnp.mean(jnp.square(target - pred))

    loss, grads = jax.value_and_grad(loss_fn)(p)
    norm = float(optax.global_norm(grads))
    assert norm > 10
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adam(cfg.learning_rate))
    updates, _ = tx.update(grads, tx.init(p), p)
    want = convqnet_state_dict_from_flax(jax.tree.map(
        np.asarray, optax.apply_updates(p, updates)))
    determined = convqnet_state_dict_from_flax(jax.tree.map(
        lambda g: np.abs(np.asarray(g)) * (10.0 / norm) >= 1e-6, grads))

    benv = types.SimpleNamespace(n_intersections=m * n, n_envs=B,
                                 device=torch.device("cpu"))
    fns = qlearn.make_fns(cfg, benv)
    main = port_convq(m, n, obs_size, params)
    ts = types.SimpleNamespace(
        main=main, chooser=port_convq(m, n, obs_size, params),
        target=port_convq(m, n, obs_size, params),
        opt=torch.optim.Adam(main.parameters(), lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8),
        rho=torch.zeros(()), train_steps=0)
    got, _, _ = fns.td_update(ts, tuple(map(torch.as_tensor,
                                            (s, a, r, nd, s1))))
    assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))
    for name, param in ts.main.state_dict().items():
        err = np.abs(param.numpy() - want[name].numpy())
        ok = determined[name].numpy().astype(bool)
        assert err.max() <= cfg.learning_rate * 1.0001, name
        if ok.any():
            assert err[ok].max() <= 1e-5, name


def test_single_agent_conv_gru_raises(tmp_path):
    """The 2^I single-agent head has no grid to share: ValueError, as
    in the JAX package."""
    cfg = Config(trainer="qlearn", conv_gru=True, single_agent=True,
                 grid_m=2, grid_n=2, num_envs=4, platform="cpu",
                 logdir=str(tmp_path / "sa")).derive()
    with pytest.raises(ValueError, match="single_agent"):
        run_alg(cfg)


def test_run_alg_conv_gru_cpu_smoke(tmp_path):
    """--conv_gru --occupancy_obs on a 2x2 grid: 2 train episodes with a
    validation, then a validate-mode restore; the trainer's nets are
    ConvQNets and the loss is finite."""
    logdir = str(tmp_path / "conv")
    kw = dict(trainer="qlearn", conv_gru=True, occupancy_obs=True,
              grid_m=2, grid_n=2, num_envs=4, episode_secs=60,
              batch_size=4, buffer_size=32, validate_rate=2,
              summary_rate=1, save_rate=100, logdir=logdir,
              platform="cpu")
    ts = run_alg(Config(total_episodes=2, **kw).derive())
    assert isinstance(ts.main, ConvQNet) and isinstance(ts.target, ConvQNet)
    assert ts.episode == 2 and ts.train_steps > 0
    assert os.path.exists(os.path.join(logdir, "model.ckpt"))
    lights, trips, unfinished = run_alg(Config(
        total_episodes=1, mode="validate", restore=True, **kw).derive())
    assert len(unfinished) == 1 and len(lights) > 0
