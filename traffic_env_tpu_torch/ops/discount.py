"""Return and advantage recurrences (counterpart of
``traffic_env_tpu/ops/discount.py``), as reverse loops over the time
axis (axis 0, any trailing shape) in float32.

``discount`` is the backward recurrence ``a[i-1] += gamma * a[i]``,
optionally normalised to an average by the geometric-sum denominators;
``gae`` is generalized advantage estimation built on the same
recurrence.  ``nd`` (1 - done, time-major, broadcast over the trailing
axes) cuts both at episode boundaries.  Each step keeps the JAX
package's expression, e.g. ``d + lamg * m * carry``, so the float32
results agree with its ``lax.scan`` to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def _mask_like(nd: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``nd`` broadcast to ``a``'s shape (trailing axes appended)."""
    nd = nd.reshape(tuple(nd.shape) + (1,) * (a.dim() - nd.dim()))
    return nd.expand(a.shape).to(F32)


def _scan_back(xs: torch.Tensor, carry: torch.Tensor, step) -> torch.Tensor:
    """Reverse scan: out[t] = carry = step(t, carry), t = T-1 .. 0."""
    out = [None] * xs.shape[0]
    for t in range(xs.shape[0] - 1, -1, -1):
        carry = step(t, carry)
        out[t] = carry
    return torch.stack(out)


def discount(a: torch.Tensor, gamma: float, use_avg: bool = False,
             nd: torch.Tensor | None = None) -> torch.Tensor:
    """Backward discounted accumulation along axis 0; returns a new
    tensor.  ``nd`` cuts the recurrence at episode boundaries."""
    g = float(np.float32(gamma))
    if nd is not None:
        m = _mask_like(nd, a)
        out = _scan_back(a, torch.zeros_like(a[-1]),
                         lambda t, c: a[t] + g * m[t] * c)
    else:
        last = a[-1]
        rest = _scan_back(a[:-1], last, lambda t, c: a[t] + g * c) \
            if a.shape[0] > 1 else a[:0]
        out = torch.cat([rest, last[None]])
    if use_avg:
        n = a.shape[0]
        if nd is not None:
            # the denominator follows the numerator's nd-masked recurrence
            denoms = _scan_back(m, torch.zeros_like(a[-1]),
                                lambda t, c: 1.0 + g * m[t] * c)
            out = out / denoms
        else:
            # denom_i = 1 + gamma + ... + gamma^(n-1-i), accumulated
            # front to back in float32
            denoms, denom, extras = [], np.float32(1.0), np.float32(gamma)
            for _ in range(n):
                denoms.append(denom)
                denom = np.float32(denom + extras)
                extras = np.float32(extras * np.float32(gamma))
            d = torch.tensor(denoms[::-1], dtype=F32, device=a.device)
            out = out / d.reshape((n,) + (1,) * (a.dim() - 1))
    return out


def gae(rewards: torch.Tensor, values: torch.Tensor,
        bootstrap: torch.Tensor, gamma: float, lam: float,
        nd: torch.Tensor | None = None):
    """Generalized advantage estimation over a time-major rollout:
    deltas ``r + gamma * V' * nd - V`` discounted by ``lam * gamma *
    nd``; returns (advantages, discounted returns).  ``nd`` None means
    no terminations."""
    g = np.float32(gamma)
    lamg = float(np.float32(lam) * g)
    g = float(g)
    vals = torch.cat([values, bootstrap[None]])
    if nd is None:
        deltas = rewards + g * vals[1:] - vals[:-1]
        advantages = discount(deltas, lam * gamma)
        drs = torch.cat([rewards, bootstrap[None]])
        return advantages, discount(drs, gamma)[:-1]
    m = _mask_like(nd, rewards)
    deltas = rewards + g * vals[1:] * m - vals[:-1]
    advantages = _scan_back(deltas, torch.zeros_like(bootstrap),
                            lambda t, c: deltas[t] + lamg * m[t] * c)
    returns = _scan_back(rewards, bootstrap,
                         lambda t, c: rewards[t] + g * m[t] * c)
    return advantages, returns
