"""Plain PyTorch reference of the a3c learner the benchmark times: the
conv-GRU actor-critic over the intersection grid, the ConvQNet
distillation teacher read from its ``.npz`` file, and one window's
update (bootstrap value, GAE cut at episode ends, SIL's clamp at zero,
sigmoid cross-entropy on the actions and the teacher's anchor, the
value loss, global-norm clipping at 40, one Adam step).

The equations follow the conv-GRU a3c of the system's published
description (flax's ``SAME`` 3x3 convolutions without bias in the
cell, state channels before input channels; 1x1 heads with bias); the
names of the parameters are the program's, so one set of weights loads
into both.  It imports nothing of the program.  ``allow_tf32`` is set
by the caller: off as the configuration states, on for the control.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CLIP_NORM = 40.0


def frame_width(d: int, v: int) -> int:
    return 13 if d % (13 * v) == 0 else 9 if d % (9 * v) == 0 else 0


def grid_maps(flat: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Batch-first flat obs (b, d), frames oldest first, each frame 9 or
    13 blocks of m * n columns -> NCHW maps (b, k * width, m, n)."""
    b, d = flat.shape
    width = frame_width(d, m * n)
    k = d // (width * m * n)
    g = flat.reshape(b, k, width, m, n)
    return g.reshape(b, k * width, m, n)


def param_shapes(m: int, n: int, c_in: int, hidden: int = 32) -> dict:
    """The conv-GRU policy's parameters, named as the program names
    them, with their shapes."""
    gate = (hidden, hidden + c_in, 3, 3)
    return {"ConvGRUCell_0.update_gate.weight": gate,
            "ConvGRUCell_0.reset_gate.weight": gate,
            "ConvGRUCell_0.candidate.weight": gate,
            "score_head.weight": (1, hidden, 1, 1), "score_head.bias": (1,),
            "value_head.weight": (1, hidden, 1, 1), "value_head.bias": (1,)}


class Policy:
    """The conv-GRU actor-critic on a dict of leaf tensors ``p``."""

    def __init__(self, p: dict, m: int, n: int):
        self.p, self.m, self.n = p, m, n

    def cell(self, h, x):
        p = self.p
        both = torch.cat([h, x], 1)
        z = torch.sigmoid(F.conv2d(both, p["ConvGRUCell_0.update_gate.weight"],
                                   padding=1))
        r = torch.sigmoid(F.conv2d(both, p["ConvGRUCell_0.reset_gate.weight"],
                                   padding=1))
        cand = torch.tanh(F.conv2d(torch.cat([r * h, x], 1),
                                   p["ConvGRUCell_0.candidate.weight"],
                                   padding=1))
        return (1 - z) * h + z * cand

    def heads(self, h):
        p, b = self.p, h.shape[0]
        s = F.conv2d(h, p["score_head.weight"], p["score_head.bias"])
        v = F.conv2d(h, p["value_head.weight"], p["value_head.bias"])
        return s.reshape(b, -1), v.reshape(b, -1)

    def step(self, obs, h):
        """One step: obs (b, d), carry (b, C, m, n) -> scores, values
        (b, m * n), the new carry."""
        h = self.cell(h, grid_maps(obs, self.m, self.n))
        s, v = self.heads(h)
        return s, v, h


class Teacher:
    """The ConvQNet teacher of a flax ``.npz`` (``params/Conv_i/kernel``
    (kh, kw, in, out) and ``bias``): three 3x3 convolutions with the
    residual block, a 1x1 head of two choices; its action is the argmax."""

    def __init__(self, path: str, m: int, n: int, device):
        with np.load(path) as z:
            self.w = [torch.tensor(np.transpose(z[f"params/Conv_{i}/kernel"],
                                                 (3, 2, 0, 1)),
                                   device=device) for i in range(4)]
            self.b = [torch.tensor(z[f"params/Conv_{i}/bias"], device=device)
                      for i in range(4)]
        self.m, self.n = m, n

    def action(self, obs):
        x = grid_maps(obs, self.m, self.n)
        w, b = self.w, self.b
        h0 = torch.relu(F.conv2d(x, w[0], b[0], padding=1))
        h1 = F.conv2d(h0, w[1], b[1], padding=1)
        resid = F.conv2d(torch.relu(h1), w[2], b[2], padding=1)
        q = F.conv2d(torch.relu(h1 + resid), w[3], b[3])   # (b, 2, m, n)
        return torch.argmax(q.reshape(q.shape[0], 2, -1), 1)


def bce(scores, labels):
    return -labels * F.logsigmoid(scores) - (1.0 - labels) \
        * F.logsigmoid(-scores)


def gae(rew, values, boot, gamma: float, lam: float, nd):
    """Advantages and returns of a time-major window, cut where ``nd``
    (1 - done) is 0, in float32 as the configuration computes them."""
    g = float(np.float32(gamma))
    lamg = float(np.float32(lam) * np.float32(gamma))
    nd = nd[..., None].expand(rew.shape)
    vals = torch.cat([values, boot[None]])
    deltas = rew + g * vals[1:] * nd - vals[:-1]
    adv, ret = [None] * rew.shape[0], [None] * rew.shape[0]
    a, r = torch.zeros_like(boot), boot
    for t in range(rew.shape[0] - 1, -1, -1):
        a = deltas[t] + lamg * nd[t] * a
        r = rew[t] + g * nd[t] * r
        adv[t], ret[t] = a, r
    return torch.stack(adv), torch.stack(ret)


class Learner:
    """The reference learner: its own copy of the weights and its own
    Adam state, stepping over the windows the program rolled out;
    ``block`` rows are the envs of one card."""

    def __init__(self, weights: dict, cfg: dict, teacher: Teacher,
                 block: int):
        self.p = {k: v.detach().clone().requires_grad_(True)
                  for k, v in weights.items()}
        self.cfg, self.teacher, self.block = cfg, teacher, block
        self.net = Policy(self.p, cfg["grid_m"], cfg["grid_n"])
        self.opt = torch.optim.Adam(list(self.p.values()),
                                    lr=cfg["learning_rate"],
                                    betas=(0.9, 0.999), eps=1e-8)

    def update(self, obs, boot_obs, act, rew, done, carry0, lr: float):
        """One window: obs (T, B, d), the obs after it (B, d), actions and
        rewards (T, B, I), done (T, B), the carry it started from.
        Returns (loss, the clipped gradient of each leaf, the carry the
        rollout ended with)."""
        c, net = self.cfg, self.net
        T = obs.shape[0]
        with torch.no_grad():
            values, carry = [], carry0
            for t in range(T):
                _, v, h = net.step(obs[t], carry)
                values.append(v)
                carry = torch.where(done[t][:, None, None, None], 0.0, h)
            boot = net.step(boot_obs, carry)[1]
            # the teacher's argmax in blocks of the rows one card runs:
            # a near tie can fall either way at another batch shape
            expert = torch.stack([
                torch.cat([self.teacher.action(x)
                           for x in obs[t].split(self.block)])
                for t in range(T)]).to(torch.float32)
            adv, ret = gae(rew / float(np.float32(c["reward_scale"])),
                           torch.stack(values), boot, c["gamma"], c["lam"],
                           1.0 - done.to(torch.float32))
            if c["sil"]:
                adv = torch.clamp(adv, min=0.0)
        scores, vals, h = [], [], carry0
        for t in range(T):
            s, v, h = net.step(obs[t], h)
            scores.append(s)
            vals.append(v)
            h = torch.where(done[t][:, None, None, None], 0.0, h)
        scores, vals = torch.stack(scores), torch.stack(vals)
        pl = torch.mean(torch.sum(adv * bce(scores, act), -1))
        pl = pl + float(np.float32(c["bc_anchor"])) * torch.mean(
            torch.sum(bce(scores, expert), -1))
        vl = 0.5 * torch.mean(torch.sum(torch.square(ret - vals), -1))
        probs = torch.sigmoid(scores)
        ent = -torch.mean(probs * torch.log(probs + 1e-8))
        loss = 0.5 * vl + pl - c["entropy_coef"] * ent
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = [q.grad for q in self.p.values()]
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        keep = norm < CLIP_NORM
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * CLIP_NORM))
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        return (loss.detach(), {k: q.grad.detach().clone()
                                for k, q in self.p.items()}, carry)
