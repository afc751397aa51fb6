"""Philox4x32-10 on int64 tensors, the counter layout of the window
kernel's device arrival stream, and the env's reset stream.

Every random draw of the window is one Philox block keyed by
``(seed[b], env_base + b)`` -- the env's seed and its global index, the
index in the batch plus the global index ``env_base`` of the batch's
first env (non-zero on the ranks of a sharded run, ``parallel/dist.py``)
-- with counter ``(global_tick, slot, 0, 0)``; the draw is word 0 of the
block.  A rank's envs so draw what the same envs draw in one batch.
Each draw of a tick has a fixed slot (see :class:`Slots`), so a lane
that is frozen or resurrected never repeats or shifts the stream of
another tick, and the kernel may skip a draw it does not use.

The JAX package seeds the TPU's own generator once per block of envs
from the block's largest global tick; the port's per-env streams give
other random bits by design.  Device-spawn mode is held to the JAX
package statistically (arrival rate), never bit for bit.

A full reset's light phase and warm-up/prefill actions come from the
same key with counter ``(resets, draw, RESET_WORD, 0)``: ``resets`` is
the env's count of full resets (``SimState.resets``), and counter word
2, which every window draw leaves 0, keeps the two streams disjoint.
The JAX package splits these draws from ``key``; they are carried in
the state for the same reason, so a checkpoint resumes them.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product of the 32-bit
    constant ``a`` and ``b`` (int64 holding values in [0, 2**32)).  The
    product is formed from 16-bit halves of ``b`` so no intermediate
    leaves the int64 range."""
    p1 = a * (b >> 16)                 # < 2**48
    p0 = a * (b & 0xFFFF)              # < 2**48
    hi = (p1 + (p0 >> 16)) >> 16
    lo = (((p1 & 0xFFFF) << 16) + p0) & MASK32
    return hi & MASK32, lo


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32 (Salmon et al., SC'11) on int64 tensors holding 32-bit
    values; broadcasts its arguments.  Returns the four output words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0 = k0 & MASK32
    k1 = k1 & MASK32
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


# the most intersections the window kernel takes (MAX_I in csrc/window.cu)
MAX_I = 64


class Slots:
    """Draw slots of one tick for ``Ks`` placements per tick:
    ``first`` (the first inter-arrival gap), ``renew`` .. ``renew +
    n_renew - 1`` (the renewal chain), ``entry`` .. ``entry + Ks - 1``
    (entry-road draws), ``phase`` .. ``phase + I - 1`` (the lazy
    reset's phase bit per intersection) and ``arch`` .. ``arch + Ks - 1``
    (each placed car's archetype with a k > 1 table).  ``arch`` lies past
    the phase range of the largest grid, so the k = 1 draws keep their
    slots."""

    def __init__(self, max_spawns_per_tick: int):
        self.n_renew = max(max_spawns_per_tick, 8)
        self.first = 0
        self.renew = 1
        self.entry = 1 + self.n_renew
        self.phase = self.entry + max_spawns_per_tick
        self.arch = self.phase + MAX_I


def _env_index(seed: torch.Tensor, env_base: int) -> torch.Tensor:
    """The key's second word: the global index of each env, int64 (B,)."""
    return torch.arange(env_base, env_base + seed.shape[-1],
                        device=seed.device, dtype=torch.int64) & MASK32


def draw_bits(seed: torch.Tensor, gtick: torch.Tensor,
              slots: torch.Tensor, env_base: int = 0) -> torch.Tensor:
    """Word 0 of the Philox block of each (slot, env): int64 (n, B) in
    [0, 2**32).  ``seed`` and ``gtick`` are int32 (B,), ``slots`` an
    integer (n,) tensor; env ``b`` is the global env ``env_base + b``."""
    env = _env_index(seed, env_base)
    k0 = seed.to(torch.int64) & MASK32
    c0 = gtick.to(torch.int64) & MASK32
    c1 = slots.to(torch.int64)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=seed.device)
    return philox4x32(c0[None, :], c1, zero, zero, k0[None, :],
                      env[None, :])[0]


def uniform24(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits of a 32-bit word as a float32 in [0, 1)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


# counter word 2 of every reset draw (the window's draws leave it 0)
RESET_WORD = 1


def reset_bits(seed: torch.Tensor, resets: torch.Tensor, n_rows: int,
               n_intersections: int, env_base: int = 0) -> torch.Tensor:
    """The 0/1 draws of one full reset: int32 (n_rows, I, B), row 0 the
    light phase and rows 1.. the warm-up and prefill actions.  Draw
    ``row * I + i`` of env ``b`` is bit 0 of word 0 of the Philox block
    with counter ``(resets[b], row * I + i, RESET_WORD, 0)`` and key
    ``(seed[b], env_base + b)``."""
    B = seed.shape[-1]
    dev = seed.device
    env = _env_index(seed, env_base)
    k0 = seed.to(torch.int64) & MASK32
    c0 = resets.to(torch.int64) & MASK32
    c1 = torch.arange(n_rows * n_intersections, device=dev,
                      dtype=torch.int64)[:, None]
    c2 = torch.full((), RESET_WORD, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    w0 = philox4x32(c0[None, :], c1, c2, zero, k0[None, :], env[None, :])[0]
    return (w0 & 1).to(torch.int32).reshape(n_rows, n_intersections, B)
