"""Device-resident experience replay (counterpart of
``traffic_env_tpu/algorithms/replay.py``): ``FrameReplay`` for qlearn,
``EpisodeReplay`` of whole episodes for qrnn.

The buffers are tensors on the learner's device, written in place.  The
insert counters ``filled`` and ``cursor`` are host integers: they
advance by one row per agent step, or by the episodes of one insert,
whatever the data, so the learner's "replay is full" gate is a Python
``if`` that never waits on the device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class FrameReplay:
    """Transition replay that stores each observation FRAME once.

    One ring row per agent step across the whole env batch: the newest
    frame after the step and that step's action, reward and 1 - done.
    The k-frame stacks the net consumes are rebuilt at sample time from
    k + 1 consecutive rows.  The rebuild is exact for the lazy-autoreset
    actor, whose history rolls straight through resets.  Capacity is
    ``size`` rows = ``size * n_envs`` transitions; sampling is uniform
    over the valid (step, env) window."""
    frames: torch.Tensor  # f32 (N, B, obs_dim) newest frame after step
    a: torch.Tensor       # i32 (N, B, heads)
    r: torch.Tensor       # f32 (N, B, reward_size)
    nd: torch.Tensor      # f32 (N, B) 1 - done
    filled: int = 0       # steps inserted, saturating at N
    cursor: int = 0       # ring write position (wraps mod N)
    k: int = 1            # history depth

    @classmethod
    def create(cls, buffer_size: int, n_envs: int, k: int, obs_dim: int,
               act_dim: int, reward_size: int, device="cuda"):
        """``buffer_size`` is the transition capacity; the ring depth is
        buffer_size / n_envs rows, floored at k + 2 so that at least two
        distinct stacks can always be rebuilt."""
        steps = max(buffer_size // max(n_envs, 1), k + 2)
        z = lambda *shape, dt=torch.float32: torch.zeros(
            shape, dtype=dt, device=device)
        return cls(frames=z(steps, n_envs, obs_dim),
                   a=z(steps, n_envs, act_dim, dt=torch.int32),
                   r=z(steps, n_envs, reward_size), nd=z(steps, n_envs),
                   k=int(k))

    @property
    def size(self) -> int:
        return self.frames.shape[0]

    def add_step(self, frame, a, r, done) -> "FrameReplay":
        """Insert one agent step across the env batch: ``frame`` is the
        newest observation frame after the step, (B, obs_dim)."""
        c = self.cursor
        self.frames[c] = frame
        self.a[c] = a
        self.r[c] = r
        self.nd[c] = 1.0 - done.to(torch.float32)
        self.filled = min(self.filled + 1, self.size)
        self.cursor = (c + 1) % self.size
        return self

    def prefill(self, frames_kbo) -> "FrameReplay":
        """Seed the ring with the env's reset-time history (k rows,
        (k, B, obs_dim)) so that ``last_stack`` is warm from step 0.  The
        rows carry dummy action and reward; they never anchor a sampled
        transition, because ``sample`` draws only from the newest
        ``filled - k`` rows."""
        k, N = frames_kbo.shape[0], self.size
        for i in range(k):
            self.frames[(self.cursor + i) % N] = frames_kbo[i]
        self.filled = min(self.filled + k, N)
        self.cursor = (self.cursor + k) % N
        return self

    def last_stack(self) -> torch.Tensor:
        """The k-frame stack the policy acts on now: the newest k rows
        in insertion order, (k, B, obs_dim)."""
        start = (self.cursor - self.k) % self.size
        if start + self.k <= self.size:
            return self.frames[start:start + self.k]
        return torch.cat([self.frames[start:], self.frames[:self.cursor]])

    def sample(self, generator: torch.Generator, n: int):
        """Uniform over valid (step, env) transitions: draws the offset
        ``u`` from the newest row and the env ``e``, then
        :meth:`sample_at`."""
        dev = self.frames.device
        m = max(self.filled - self.k, 1)        # valid step count
        u = torch.randint(0, m, (n,), generator=generator, device=dev)
        e = torch.randint(0, self.frames.shape[1], (n,), generator=generator,
                          device=dev)
        return self.sample_at(u, e)

    def sample_at(self, u: torch.Tensor, e: torch.Tensor):
        """Transitions at offsets ``u`` from the newest row and envs
        ``e``.  Transition j consumes frames j-k..j: s = stack(j-k..j-1)
        (the obs the actor saw when choosing a(j)), s1 = stack(j-k+1..j).
        Returns (s, a, r, nd, s1) with nd of shape (n, 1)."""
        N = self.size
        u, e = u.long(), e.long()
        j = (self.cursor - 1 - u) % N                    # row of frame(j)
        offs = torch.arange(self.k, device=u.device)
        idx_s = (j[:, None] - self.k + offs[None, :]) % N   # (n, k)
        s = self.frames[idx_s, e[:, None]]               # (n, k, obs)
        s1 = self.frames[(idx_s + 1) % N, e[:, None]]
        return s, self.a[j, e], self.r[j, e], self.nd[j, e][:, None], s1

    def state_dict(self) -> dict:
        return {"frames": self.frames, "a": self.a, "r": self.r,
                "nd": self.nd, "filled": self.filled, "cursor": self.cursor,
                "k": self.k}

    def load_state_dict(self, sd: dict) -> None:
        for name in ("frames", "a", "r", "nd"):
            getattr(self, name).copy_(sd[name])
        self.filled, self.cursor = int(sd["filled"]), int(sd["cursor"])
        self.k = int(sd["k"])


@dataclasses.dataclass
class EpisodeReplay:
    """Episode-level replay for the recurrent learner: whole episodes
    with their real lengths in a ring of ``size`` slots; sampling draws
    one contiguous trace of up to ``n_exp`` steps from each of ``n_ep``
    episodes."""
    s: torch.Tensor       # f32 (N, T + 1, obs_dim) observations
    a: torch.Tensor       # i32 (N, T, act_dim)
    r: torch.Tensor       # f32 (N, T, reward_size)
    nd: torch.Tensor      # f32 (N, T) 1 - done
    lens: torch.Tensor    # i32 (N,) steps of each stored episode
    filled: int = 0       # episodes inserted, saturating at N
    cursor: int = 0       # ring write position (wraps mod N)

    @classmethod
    def create(cls, size: int, episode_len: int, obs_dim: int,
               act_dim: int, reward_size: int, device="cuda"):
        z = lambda *shape, dt=torch.float32: torch.zeros(
            shape, dtype=dt, device=device)
        return cls(s=z(size, episode_len + 1, obs_dim),
                   a=z(size, episode_len, act_dim, dt=torch.int32),
                   r=z(size, episode_len, reward_size),
                   nd=z(size, episode_len),
                   lens=z(size, dt=torch.int32))

    @property
    def size(self) -> int:
        return self.s.shape[0]

    def add_episodes(self, s_seq, a_seq, r_seq, nd_seq, lengths
                     ) -> "EpisodeReplay":
        """Insert B whole episodes, episode-major (``s_seq`` holds T + 1
        observations).  When B exceeds the ring, a rotating subset of
        ``size`` of them is kept, ``(cursor * 13 + arange(size)) % B``;
        the cursor advances by B, not by the kept count, so that the
        subset rotates when B is a multiple of the size."""
        b = orig_b = lengths.shape[0]
        n = self.size
        dev = self.s.device
        if b > n:
            sel = (self.cursor * 13 + torch.arange(n, device=dev)) % b
            s_seq, a_seq, r_seq = s_seq[sel], a_seq[sel], r_seq[sel]
            nd_seq, lengths = nd_seq[sel], lengths[sel]
            b = n
        slots = (self.cursor + torch.arange(b, device=dev)) % n
        for buf, x in ((self.s, s_seq), (self.a, a_seq), (self.r, r_seq),
                       (self.nd, nd_seq), (self.lens, lengths)):
            buf[slots] = x.to(buf.dtype)
        self.filled = min(self.filled + b, n)
        self.cursor = (self.cursor + orig_b) % n
        return self

    def sample_traces(self, generator: torch.Generator, n_ep: int,
                      n_exp: int):
        """Draws the episodes ``i`` (uniform over the ring) and a float32
        uniform for each trace's start, then :meth:`sample_traces_at`."""
        dev = self.s.device
        i = torch.randint(0, self.size, (n_ep,), generator=generator,
                          device=dev)
        u = torch.rand((n_ep,), generator=generator, device=dev)
        return self.sample_traces_at(i, u, n_exp)

    def sample_traces_at(self, i: torch.Tensor, u: torch.Tensor,
                         n_exp: int):
        """Episode ``i[k]``'s trace starts at ``int(u[k] * max(1, len -
        n_exp + 1))`` and runs ``min(n_exp, len)`` steps; steps past it
        read step 0 (zero padding by index), and ``s1`` is the step
        after each.  Returns (s, a, r, nd, s1, sizes), time axis
        ``n_exp``."""
        i = i.long()
        lens = self.lens[i]
        sizes = torch.clamp(lens, max=n_exp)
        max_start = torch.clamp(lens - n_exp + 1, min=1)
        start = (u.to(torch.float32) * max_start.to(torch.float32)).to(
            torch.int32)
        offs = torch.arange(n_exp, device=i.device)[None, :]
        valid = offs < sizes[:, None]
        j = torch.where(valid, start[:, None] + offs, 0).long()
        ii = i[:, None]
        return (self.s[ii, j], self.a[ii, j], self.r[ii, j],
                self.nd[ii, j], self.s[ii, j + 1], sizes)

    def state_dict(self) -> dict:
        return {"s": self.s, "a": self.a, "r": self.r, "nd": self.nd,
                "lens": self.lens, "filled": self.filled,
                "cursor": self.cursor}

    def load_state_dict(self, sd: dict) -> None:
        for name in ("s", "a", "r", "nd", "lens"):
            getattr(self, name).copy_(sd[name])
        self.filled, self.cursor = int(sd["filled"]), int(sd["cursor"])
