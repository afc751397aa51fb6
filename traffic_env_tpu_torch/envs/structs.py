"""Simulator state of a batch of envs.

Every leaf is a tensor with the env batch as its *last* axis (the JAX
package's vmapped layout), so the env index is the coalesced axis on
the GPU and a leaf compares directly with its JAX counterpart.

Slot layout: each road is a ring of RING = 19 slots; ``leading`` is the
fake-leader slot and ``lastcar`` the most recent car, so the cars of a
road sit at ring distances 1..(lastcar - leading) % RING from the
leader.  Only x / v / w (position, speed, spawn tick) vary per car; the
other car parameters are those of the single archetype.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SimState:
    cars: torch.Tensor         # f32 (R, 3, RING, B): rows x, v, w
    leading: torch.Tensor      # i32 (R, B) ring index of the fake leader
    lastcar: torch.Tensor      # i32 (R, B) ring index of the newest car
    phase: torch.Tensor        # i32 (I, B) light phase per intersection
    elapsed: torch.Tensor      # i32 (I, B) ticks since the last change
    passed: torch.Tensor       # i32 (Rt, B) cars through this tick
    detected: torch.Tensor     # i32 (Rt, B) cars near the stop line
    waiting: torch.Tensor      # i32 (Rt, B) accumulated stopped cars
    passed_dst: torch.Tensor   # bool (I, B) any passing since last remi
    rewards: torch.Tensor      # f32 (I, B) per-intersection reward
    steps: torch.Tensor        # i32 (B,) per-episode tick counter
    global_tick: torch.Tensor  # i32 (B,) tick cursor, kept across resets
    spawn_gap: torch.Tensor    # i32 (B,) empty ticks left in the arrival
                               # stream (-1: no gap drawn yet)
    spawn_backlog: torch.Tensor  # i32 (B,) arrivals deferred by the
                                 # per-tick placement cap
    # i32 (B,) Philox key of each env's device arrival stream.  The JAX
    # package carries a threefry key here instead (field ``key``).
    seed: torch.Tensor
    done: torch.Tensor         # bool (B,) overflow flag
    # i32 (episode_ticks + 2, B) validate-mode trip-time histogram in
    # ticks, one column per env; None outside validate mode
    trip_hist: torch.Tensor | None = None

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "SimState":
        """A copy that shares no tensor with this state."""
        return self.replace(**{k: v.clone() for k, v in vars(self).items()
                               if v is not None})


@dataclasses.dataclass
class SpawnSchedule:
    """Host-precomputed arrival stream (schedule mode), indexed by
    ``global_tick - base`` so it persists across episode resets."""
    counts: torch.Tensor            # i32 (T, B) cars arriving at each tick
    roads: torch.Tensor             # i32 (T, K, B) entry road ids
    base: torch.Tensor | int = 0    # absolute tick of row 0 (per env)

    @classmethod
    def from_numpy(cls, counts, roads, base=0, device="cuda"):
        dev = torch.device(device)
        return cls(counts=torch.as_tensor(counts, dtype=torch.int32,
                                          device=dev),
                   roads=torch.as_tensor(roads, dtype=torch.int32,
                                         device=dev),
                   base=torch.as_tensor(base, dtype=torch.int32,
                                        device=dev))
