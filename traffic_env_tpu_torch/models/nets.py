"""Q networks and the GRU actor-critics (counterpart of
``traffic_env_tpu/models/nets.py``).

``QNet`` is the double-DQN trunk with a residual block: obs -> 200 relu
-> 200 -> +resid(200) -> relu -> per-intersection Q values of shape
(heads, choices).  ``ConvQNet`` (``--conv_gru`` with qlearn) is the same
residual structure with 3x3 convolutions over the (m, n) intersection
grid in place of the dense layers, on the grid maps of
``obs_grid_channels``.  Their layers are ``nn.Linear`` and ``nn.Conv2d``
(the JAX package leaves them to XLA; no kernel of its own), in float32:
the trainer turns TF32 off (``algorithms/qlearn.py:make_state``).
The recurrent nets (``A3CNet``, ``DuelingQRNN``, ``PolGradNet`` and the
conv-GRU a3c policy) run flax's GRU cell over a time axis in a loop.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import trace

WIDTH = 200


def _orthogonal_(weight: torch.Tensor, generator=None) -> None:
    """flax's default recurrent kernel init (``initializers.orthogonal``)."""
    nn.init.orthogonal_(weight, generator=generator)


def _lecun_normal_(weight: torch.Tensor, generator=None) -> None:
    """flax's default Dense and Conv kernel init: variance 1/fan_in
    (inputs times kernel area), normal truncated at two standard
    deviations."""
    fan_in = weight[0].numel()
    # 0.8796... is the std of the unit normal truncated to (-2, 2)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class QNet(nn.Module):
    """Returns (batch, n_actions, n_choices) Q values from a batch-first
    observation of any trailing shape (flattened).  ``n_choices=2`` is
    the per-intersection phase pair; ``--single_agent`` uses one head
    with 2^I choices.  The weights are drawn from ``generator`` as flax
    initialises Dense layers (lecun normal, zero bias)."""

    def __init__(self, obs_size: int, n_actions: int, n_choices: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_actions, self.n_choices = n_actions, n_choices
        self.dense = nn.ModuleList([
            nn.Linear(obs_size, WIDTH), nn.Linear(WIDTH, WIDTH),
            nn.Linear(WIDTH, WIDTH),
            nn.Linear(WIDTH, n_actions * n_choices)])
        for layer in self.dense:
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.reshape(obs.shape[0], -1)
        d0, d1, d2, d3 = self.dense
        h0 = torch.relu(d0(x))
        h1 = d1(h0)
        resid = d2(torch.relu(h1))
        h2 = torch.relu(h1 + resid)
        return d3(h2).reshape(-1, self.n_actions, self.n_choices)


def _frame_width(d: int, v: int) -> int:
    """Observation columns per intersection in one history frame of a
    ``d``-wide flat obs over ``v`` intersections: 13 with
    --occupancy_obs, else 9, preferring 13 when both divide; 0 when
    neither does."""
    return 13 if d % (13 * v) == 0 else 9 if d % (9 * v) == 0 else 0


def _grid_maps(flat: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Batch-first flat observation (..., d) -> (..., C, m, n) grid maps,
    a view of it.

    A frame is the per-road passed and detected counts (4 directions
    each), the per-intersection phase feature and, with
    --occupancy_obs, four occupancy blocks: 9 or 13 blocks of m * n
    columns, a road's id within a block row * n + col.  With
    --history=k the flat obs is k frames, oldest first, and each frame
    is a channel group: C = 9k or 13k.  When no frame width divides
    ``d`` the maps are 9 channels of zeros, as in the JAX package."""
    lead = tuple(flat.shape[:-1])
    width = _frame_width(flat.shape[-1], m * n)
    if not width:
        return flat.new_zeros(lead + (9, m, n))
    return flat.reshape(lead + (flat.shape[-1] // (m * n), m, n))


def obs_grid_channels(flat: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """``_grid_maps`` channels last, (..., m, n, C), a view."""
    return _grid_maps(flat, m, n).movedim(-3, -1)


class ConvQNet(nn.Module):
    """Grid-native double-DQN trunk: QNet's residual structure with
    weight-shared 3x3 convolutions (``channels`` wide, zero padding 1,
    flax's ``SAME``) over the (m, n) intersection grid and a 1x1 head.
    Flat obs of ``obs_size`` columns in, (batch, m * n, n_choices) Q
    values out.  The weights are drawn from ``generator`` as flax
    initialises Conv layers (lecun normal over kh * kw * C_in, zero
    bias)."""

    def __init__(self, m: int, n: int, obs_size: int, n_choices: int = 2,
                 channels: int = 64,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.m, self.n, self.n_choices = m, n, n_choices
        width = _frame_width(obs_size, m * n)
        c_in = obs_size // (m * n) if width else 9
        conv3 = lambda c: nn.Conv2d(c, channels, 3, padding=1)
        self.conv = nn.ModuleList([conv3(c_in), conv3(channels),
                                   conv3(channels),
                                   nn.Conv2d(channels, n_choices, 1)])
        for layer in self.conv:
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        b = obs.shape[0]
        g = obs_grid_channels(obs.reshape(b, -1), self.m, self.n)
        x = g.permute(0, 3, 1, 2)                   # NHWC -> NCHW
        c0, c1, c2, c3 = self.conv
        h0 = torch.relu(c0(x))
        h1 = c1(h0)
        resid = c2(torch.relu(h1))
        h2 = torch.relu(h1 + resid)
        q = c3(h2).permute(0, 2, 3, 1)              # (b, m, n, choices)
        return q.reshape(b, self.m * self.n, self.n_choices)


def _dense(n_in: int, n_out: int, generator, bias: bool = True,
           init=_lecun_normal_) -> nn.Linear:
    """A flax ``Dense``: ``init`` kernel, zero bias."""
    layer = nn.Linear(n_in, n_out, bias=bias)
    init(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class GRUCell(nn.Module):
    """flax 0.12's ``nn.GRUCell`` (not ``torch.nn.GRUCell``): with
    ``ir``/``iz``/``in`` on the input and ``hr``/``hz``/``hn`` on the
    state,

        r = sigmoid(ir(x) + hr(h)),  z = sigmoid(iz(x) + hz(h)),
        n = tanh(in(x) + r * hn(h)),  h' = (1 - z) * n + z * h,

    where the input layers and ``hn`` carry a bias and ``hr``/``hz`` do
    not.  Input kernels lecun normal, recurrent kernels orthogonal,
    biases zero.  ``input_gates`` computes the input layers of a whole
    sequence at once; ``step`` takes one step's of them and the state."""

    def __init__(self, n_in: int, hidden: int, generator=None):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, _dense(n_in, hidden, generator))
        for name in ("hr", "hz"):
            self.add_module(name, _dense(hidden, hidden, generator,
                                         bias=False, init=_orthogonal_))
        self.add_module("hn", _dense(hidden, hidden, generator,
                                     init=_orthogonal_))

    def input_gates(self, x: torch.Tensor):
        return (self.ir(x), self.iz(x), getattr(self, "in")(x))

    def step(self, gates, h: torch.Tensor) -> torch.Tensor:
        xr, xz, xn = gates
        r = torch.sigmoid(xr + self.hr(h))
        z = torch.sigmoid(xz + self.hz(h))
        n = torch.tanh(xn + r * self.hn(h))
        return (1.0 - z) * n + z * h


def _run_cell(n_steps, cell_step, carry, reset):
    """Run ``carry = cell_step(t, carry)`` for t < n_steps; where
    ``reset[:, t]`` the carry is zeroed after step t (an env that
    finished at step t starts step t + 1 from zeros).  Returns the stack
    of the unmasked outputs on axis 1 and the final (masked) carry."""
    outs = []
    for t in range(n_steps):
        h = cell_step(t, carry)
        outs.append(h)
        if reset is not None:
            keep = ~reset[:, t].reshape((-1,) + (1,) * (h.dim() - 1))
            h = torch.where(keep, h, 0.0)
        carry = h
    return torch.stack(outs, 1), carry


def _gru_trunk(net: nn.Module, obs: torch.Tensor, carry, reset):
    """``relu(Dense_0(obs))`` through ``GRUCell_0`` over the time axis
    of a batch-first (B, T, ...) obs, from ``carry`` (zeros when None):
    the (B, T, hidden) outputs and the final carry."""
    b, t = obs.shape[0], obs.shape[1]
    x = torch.relu(net.Dense_0(obs.reshape(b, t, -1)))
    if carry is None:
        carry = net.initial_carry(b, obs.device)
    cell = net.GRUCell_0
    gates = cell.input_gates(x)
    return _run_cell(
        t, lambda i, h: cell.step(tuple(g[:, i] for g in gates), h),
        carry, reset)


class A3CNet(nn.Module):
    """The a3c actor-critic: batch-first obs (B, T, ...) and a carry
    (B, hidden) in; scores (B, T, n_actions), values (B, T, reward_size)
    and the final carry out.  ``reset`` (B, T) bool, when given, zeroes
    the carry after each step it marks, as the rollout does at an
    env's autoreset.  Layers: ``Dense_0``, ``GRUCell_0``, ``Dense_1``,
    ``score_layer``, ``value_layer``, drawn from ``generator`` as flax
    initialises them."""

    def __init__(self, obs_size: int, n_actions: int, reward_size: int,
                 hidden: int = 160, generator=None):
        super().__init__()
        self.hidden = hidden
        self.Dense_0 = _dense(obs_size, hidden, generator)
        self.GRUCell_0 = GRUCell(hidden, hidden, generator)
        self.Dense_1 = _dense(hidden, hidden, generator)
        self.score_layer = _dense(hidden, n_actions, generator)
        self.value_layer = _dense(hidden, reward_size, generator)

    def initial_carry(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros(batch, self.hidden, device=device)

    def forward(self, obs: torch.Tensor, carry: torch.Tensor,
                reset: torch.Tensor | None = None):
        seq, carry = _gru_trunk(self, obs, carry, reset)
        h0 = torch.relu(self.Dense_1(seq))
        return self.score_layer(h0), self.value_layer(h0), carry


class DuelingQRNN(nn.Module):
    """The qrnn double dueling DRQN: batch-first obs (B, T, ...) and a
    carry (B, hidden), zeros when None, in; Q (B, T, n_actions,
    n_choices) and the final carry out.  ``Dense_0`` (180, relu),
    ``GRUCell_0``, ``Dense_1`` (180, relu) split 90/90 into the
    advantage head ``Dense_2`` and the value head ``Dense_3``, both of
    ``n_actions * n_choices`` outputs (the value head is not one scalar,
    as in the JAX package); ``Q = val + adv - mean(adv)`` over the
    choices.  ``reset`` as in ``A3CNet``."""

    def __init__(self, obs_size: int, n_actions: int, n_choices: int = 2,
                 hidden: int = 220, generator=None):
        super().__init__()
        self.n_actions, self.n_choices, self.hidden = (n_actions, n_choices,
                                                       hidden)
        heads = n_actions * n_choices
        self.Dense_0 = _dense(obs_size, 180, generator)
        self.GRUCell_0 = GRUCell(180, hidden, generator)
        self.Dense_1 = _dense(hidden, 180, generator)
        self.Dense_2 = _dense(90, heads, generator)
        self.Dense_3 = _dense(90, heads, generator)

    def initial_carry(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros(batch, self.hidden, device=device)

    def forward(self, obs: torch.Tensor, carry: torch.Tensor | None = None,
                reset: torch.Tensor | None = None):
        seq, carry = _gru_trunk(self, obs, carry, reset)
        mid = torch.relu(self.Dense_1(seq))
        shape = tuple(mid.shape[:2]) + (self.n_actions, self.n_choices)
        adv = self.Dense_2(mid[..., :90]).reshape(shape)
        val = self.Dense_3(mid[..., 90:]).reshape(shape)
        return val + adv - torch.mean(adv, dim=-1, keepdim=True), carry


class PolGradNet(nn.Module):
    """The polgrad_rnn policy: batch-first obs (B, T, ...) and a carry
    (B, hidden), zeros when None, in; Bernoulli scores (B, T, n_actions)
    and the final carry out.  ``Dense_0`` (200, relu), ``GRUCell_0``,
    ``Dense_1`` and ``Dense_2`` (200, relu), ``score_layer``.  ``reset``
    as in ``A3CNet``."""

    def __init__(self, obs_size: int, n_actions: int, hidden: int = 250,
                 generator=None):
        super().__init__()
        self.hidden = hidden
        self.Dense_0 = _dense(obs_size, 200, generator)
        self.GRUCell_0 = GRUCell(200, hidden, generator)
        self.Dense_1 = _dense(hidden, 200, generator)
        self.Dense_2 = _dense(200, 200, generator)
        self.score_layer = _dense(200, n_actions, generator)

    def initial_carry(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros(batch, self.hidden, device=device)

    def forward(self, obs: torch.Tensor, carry: torch.Tensor | None = None,
                reset: torch.Tensor | None = None):
        seq, carry = _gru_trunk(self, obs, carry, reset)
        h1 = torch.relu(self.Dense_2(torch.relu(self.Dense_1(seq))))
        return self.score_layer(h1), carry


def _tap_shifts(m: int, n: int) -> torch.Tensor:
    """(9, m * n, m * n) of 0 and 1: [t, p, q] is 1 where tap t (row
    major over a 3x3 kernel) of a SAME convolution at output position q
    reads input position p (positions row * n + col): each tap's
    one-hot kernel convolved with each position's one-hot map."""
    maps = torch.eye(m * n).reshape(m * n, 1, m, n)
    taps = torch.eye(9).reshape(9, 1, 3, 3)
    return F.conv2d(maps, taps, padding=1).reshape(m * n, 9, m * n) \
        .transpose(0, 1).contiguous()


def _dense_kernel(w: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """A 3x3 SAME convolution's kernel w (C_out, C_in, 3, 3) as the
    (C_in * m * n, C_out * m * n) matrix M of it on maps flattened
    channels first: ``conv2d(x, w, padding=1).flatten(1) ==
    x.flatten(1) @ M``."""
    k, c = w.shape[:2]
    mn = shifts.shape[1]
    return torch.einsum("kct,tpq->cpkq", w.reshape(k, c, 9),
                        shifts).reshape(c * mn, k * mn)


class _InputConv(torch.autograd.Function):
    """``conv2d(x[i], w, padding=1)`` for each step i of time-major maps
    x (T, N, C, m, n), stacked.  The kernel's gradient is one product of
    all T * N maps with the output's gradient, on the kernel's dense
    matrix (``_dense_kernel``); the maps' gradient, where they need one,
    is the transposed convolution."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, shifts):
        return torch.stack([F.conv2d(xi, w, padding=1) for xi in x])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        x, w, shifts = ctx.saved_tensors
        k, c = w.shape[:2]
        mn = shifts.shape[1]
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = F.conv_transpose2d(grad.reshape((-1,) + grad.shape[2:]), w,
                                    padding=1).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gm = x.reshape(-1, c * mn).T @ grad.reshape(-1, k * mn)
            gw = torch.einsum("cpkq,tpq->kct", gm.reshape(c, mn, k, mn),
                              shifts).reshape(w.shape)
        return gx, gw, None


class ConvGRUCell(nn.Module):
    """The 2-D convolutional GRU cell over (B, C, m, n) maps: 3x3 SAME
    convolutions without bias, named as flax's,

        z = sigmoid(update_gate([h, x])),  r = sigmoid(reset_gate([h, x])),
        h~ = tanh(candidate([r * h, x])),  h' = (1 - z) * h + z * h~,

    with the state's channels before the input's.  A gate's kernel is
    [W^h | W^x] along its input axis, so its convolution of [h, x] is
    conv(h, W^h) + conv(x, W^x), and the x terms need no state:
    ``input_gates`` computes those of the three gates for a whole
    sequence before the recurrence, and ``step`` adds one step's of them
    to the state's terms.  The state's convolutions are products with
    the kernels' dense matrices over the m x n map (``kernels``)."""

    def __init__(self, n_in: int, hidden: int, m: int, n: int,
                 generator=None):
        super().__init__()
        self.hidden = hidden
        for name in ("update_gate", "reset_gate", "candidate"):
            conv = nn.Conv2d(hidden + n_in, hidden, 3, padding=1,
                             bias=False)
            _lecun_normal_(conv.weight, generator)
            self.add_module(name, conv)
        self.register_buffer("shifts", _tap_shifts(m, n), persistent=False)

    def kernels(self):
        """(the input's kernels of z, r and h~ stacked, the dense matrix
        of the state's kernels of z and r stacked, that of h~'s)."""
        ws = (self.update_gate.weight, self.reset_gate.weight,
              self.candidate.weight)
        hid = self.hidden
        return (torch.cat([w[:, hid:] for w in ws]),
                _dense_kernel(torch.cat([w[:, :hid] for w in ws[:2]]),
                              self.shifts),
                _dense_kernel(ws[2][:, :hid], self.shifts))

    def input_gates(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Time-major maps (T, N, C_in, m, n) and the input's kernels ->
        the input's terms of z, r and h~ stacked on the channels, (T, N,
        3 * hidden, m, n)."""
        return _InputConv.apply(x, w, self.shifts)

    def step(self, gates: torch.Tensor, h: torch.Tensor, m_zr: torch.Tensor,
             m_c: torch.Tensor) -> torch.Tensor:
        """One step from the state h, the step's ``input_gates`` and the
        state's dense matrices."""
        hid = self.hidden
        xz, xr, xc = gates.split(hid, 1)
        b = h.shape[0]
        zr = (h.reshape(b, -1) @ m_zr).reshape(b, 2 * hid, *h.shape[2:])
        z = torch.sigmoid(zr[:, :hid] + xz)
        r = torch.sigmoid(zr[:, hid:] + xr)
        h_tilde = torch.tanh(((r * h).reshape(b, -1) @ m_c).reshape(h.shape)
                             + xc)
        return (1 - z) * h + z * h_tilde


class ConvGRUA3CNet(nn.Module):
    """The conv-GRU a3c policy over the intersection grid: batch-first
    flat obs (B, T, d) -> ``_grid_maps`` -> ``ConvGRUCell``
    over T -> 1x1 ``score_head``/``value_head`` convolutions with bias:
    scores and values (B, T, m * n), intersection row * n + col.  The
    cell's input terms of all T steps are computed before the
    recurrence (span ``convgru.input``; the counter
    ``convgru.input_steps`` adds T a call).

    The carry is channels-first, (B, hidden_channels, m, n); the JAX
    package's is (B, m, n, hidden_channels), so carries cross with a
    permute (0, 3, 1, 2).  ``reset`` as in ``A3CNet``."""

    def __init__(self, m: int, n: int, obs_size: int,
                 hidden_channels: int = 32, generator=None):
        super().__init__()
        self.m, self.n, self.hidden = m, n, hidden_channels
        width = _frame_width(obs_size, m * n)
        c_in = obs_size // (m * n) if width else 9
        self.ConvGRUCell_0 = ConvGRUCell(c_in, hidden_channels, m, n,
                                         generator)
        for name in ("score_head", "value_head"):
            conv = nn.Conv2d(hidden_channels, 1, 1)
            _lecun_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)
            self.add_module(name, conv)

    def initial_carry(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros(batch, self.hidden, self.m, self.n,
                           device=device)

    def forward(self, obs: torch.Tensor, carry: torch.Tensor,
                reset: torch.Tensor | None = None):
        b, t = obs.shape[0], obs.shape[1]
        # time-major channels-first maps (a view of a time-major obs)
        x = _grid_maps(obs.reshape(b, t, -1).transpose(0, 1), self.m,
                       self.n)
        cell = self.ConvGRUCell_0
        w_x, m_zr, m_c = cell.kernels()
        with trace.span("convgru.input"):
            gates = cell.input_gates(x, w_x).unbind(0)
        trace.count("convgru.input_steps", t)
        seq, carry = _run_cell(
            t, lambda i, h: cell.step(gates[i], h, m_zr, m_c), carry, reset)
        flat = seq.reshape((b * t,) + tuple(seq.shape[2:]))
        head = lambda conv: conv(flat).reshape(b, t, self.m * self.n)
        return head(self.score_head), head(self.value_head), carry
