"""``ConvGRUA3CNet`` with the cell's input convolution computed once
for the whole sequence, against a plain copy of the cell that convolves
the concatenated [h, x] (and [r * h, x]) a gate and a step, on the CPU:
outputs, parameter gradients and ``torch.func.jacrev`` input gradients;
and the tracer's ``convgru.input`` span and ``convgru.input_steps``
counter.  This file imports no JAX (``tests/test_torch_gpu.py`` uses
``concat_forward`` on the card)."""

import pytest
import torch
import torch.nn.functional as F

from traffic_env_tpu_torch.algorithms import a3c
from traffic_env_tpu_torch.config import Config
from traffic_env_tpu_torch.models.nets import (ConvGRUA3CNet,
                                               obs_grid_channels)
from traffic_env_tpu_torch.utils import trace


def concat_forward(net, obs, carry, reset=None):
    """``net``'s forward as a plain loop: each step three 3x3 SAME
    convolutions of the state's channels concatenated before the step's
    input maps, on ``net``'s own weights."""
    cell = net.ConvGRUCell_0
    b, t = obs.shape[0], obs.shape[1]
    x = obs_grid_channels(obs.reshape(b, t, -1), net.m, net.n)
    x = x.permute(0, 1, 4, 2, 3)
    conv = lambda gate, inp: F.conv2d(inp, gate.weight, padding=1)
    h, outs = carry, []
    for i in range(t):
        both = torch.cat([h, x[:, i]], 1)
        z = torch.sigmoid(conv(cell.update_gate, both))
        r = torch.sigmoid(conv(cell.reset_gate, both))
        cand = torch.tanh(conv(cell.candidate, torch.cat([r * h, x[:, i]], 1)))
        h = (1 - z) * h + z * cand
        outs.append(h)
        if reset is not None:
            h = torch.where(reset[:, i, None, None, None], 0.0, h)
    flat = torch.stack(outs, 1).reshape((b * t,) + tuple(carry.shape[1:]))
    head = lambda c: c(flat).reshape(b, t, net.m * net.n)
    return head(net.score_head), head(net.value_head), h


def _inputs(m, n, width, k, T, seed, B=8):
    """(net, obs (B, T, d), a non-zero carry, resets after step 1 for
    every other env)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    d = k * width * m * n
    net = ConvGRUA3CNet(m, n, d, generator=gen)
    obs = torch.rand((B, T, d), generator=gen) * 2
    carry = torch.rand(net.initial_carry(B).shape, generator=gen) - 0.5
    reset = torch.zeros((B, T), dtype=torch.bool)
    reset[::2, min(1, T - 1)] = True
    return net, obs, carry, reset


def _close(got, want, what):
    tol = 1e-5 * float(want.detach().abs().max())
    assert got.shape == want.shape, what
    assert float((got - want).detach().abs().max()) <= tol, what


# (m, n, frame width, frames, T): occupancy obs at history 20 on 3x3 and
# 5x5, 9-wide frames, a grid of other sides
CASES = [(3, 3, 13, 20, 1), (3, 3, 13, 20, 6), (5, 5, 13, 20, 1),
         (5, 5, 13, 20, 6), (5, 5, 9, 2, 6), (2, 3, 13, 4, 6)]


@pytest.mark.parametrize("m,n,width,k,T", CASES)
def test_hoisted_convgru_matches_concatenated_cell(m, n, width, k, T):
    """From a non-zero carry, with resets after step 1 for half the
    envs: scores, values and the final carry within 1e-5 of the largest
    |value| of the concatenated cell's; every parameter's gradient of a
    scalar loss over scores and values within 1e-5 of that tensor's
    largest |grad|; and the obs and carry gradients of the batch-mean
    probability (``a3c._grad_summaries``' ``mean_probs``) under
    ``torch.func.jacrev`` within the same tolerance.  Float32 sums in
    another order."""
    net, obs, carry, reset = _inputs(m, n, width, k, T, seed=m * T + width)
    wts = torch.randn((2, 8, T, m * n), generator=torch.Generator()
                      .manual_seed(T))
    grads = []
    outs = []
    for fwd in (net, lambda *a: concat_forward(net, *a)):
        net.zero_grad(set_to_none=True)
        s, v, c = fwd(obs, carry, reset)
        (torch.sum(wts[0] * s) + torch.sum(wts[1] * v ** 2)
         + torch.sum(c ** 2)).backward()
        outs.append((s.detach(), v.detach(), c.detach()))
        grads.append({n: p.grad.clone() for n, p in net.named_parameters()})
    for got, want, what in zip(outs[0], outs[1], ("scores", "values",
                                                   "carry")):
        _close(got, want, what)
    assert grads[0].keys() == grads[1].keys()
    for name, want in grads[1].items():
        _close(grads[0][name], want, name)

    def mean_probs(fwd):
        def f(o, h):
            s, _, _ = fwd(o, h)
            return torch.mean(torch.sigmoid(s), dim=(0, 1))
        return f

    jac = [torch.func.jacrev(mean_probs(fwd), argnums=(0, 1))(obs, carry)
           for fwd in (net, lambda o, h: concat_forward(net, o, h))]
    for got, want, what in zip(jac[0], jac[1], ("obs_grad", "state_grad")):
        _close(got, want, what)


@pytest.fixture
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.mark.parametrize("T", [1, 6])
def test_input_span_and_counter(T, fresh_tracer):
    """With the tracer on, one forward of T steps records the
    ``convgru.input`` span once and adds T to ``convgru.input_steps``;
    with it off, nothing is recorded."""
    net, obs, carry, reset = _inputs(3, 3, 13, 20, T, seed=T)
    with torch.no_grad():
        net(obs, carry, reset)
    assert trace.snapshot() == {"spans": {}, "counters": {},
                                "phase_cycles": {}}
    trace.enable()
    with torch.no_grad():
        net(obs, carry, reset)
    trace.disable()
    snap = trace.snapshot()
    assert set(snap["spans"]) == {"convgru.input"}
    assert snap["spans"]["convgru.input"]["count"] == 1
    assert snap["counters"] == {"convgru.input_steps": T}


def test_a3c_window_counts_the_replay_as_one_input_convolution(
        fresh_tracer):
    """One conv-GRU a3c window of T steps: T + 2 input convolutions (a
    step each in the rollout, the bootstrap, the loss replay) over
    2 T + 1 steps, so the replay's covers T."""
    T = 4
    ctx, ts = a3c.make_state(Config(
        trainer="a3c", conv_gru=True, occupancy_obs=True, grid_m=2,
        grid_n=2, num_envs=4, batch_size=T, episode_secs=40, seed=3,
        platform="cpu").derive())
    trace.enable()
    ctx.fns.run_window(ts)
    trace.disable()
    snap = trace.snapshot()
    assert snap["spans"]["convgru.input"]["count"] == T + 2
    assert snap["counters"]["convgru.input_steps"] == 2 * T + 1

