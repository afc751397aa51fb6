"""Host-side renderer of simulator snapshots (counterpart of
``traffic_env_tpu/render.py``).

The reference renders with pyglet inside the env loop: roads drawn as
segments, each training road coloured by its light (green; yellow while
``elapsed < YELLOW_TICKS``; red), cars drawn as ``[x - l, x]``
sub-segments along the road.  Here a snapshot is one env's lane of a
batched ``SimState``, fetched from the card in one small copy, drawn
with matplotlib (Agg) into PNGs (``EpisodeRenderer``, a GIF too when
pillow is there) or as ANSI text (``TermRenderer``, ``--render_live``),
which needs neither.  ``--render`` draws one frame per agent step,
``--render_ticks`` one per simulator tick from the per-tick core's
tick stack.  matplotlib is imported only by the functions that draw.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .constants import ARCHETYPES, L, RING, YELLOW_TICKS
from .envs.structs import SimState
from .topology import GridRoad

CAR_LENGTH = float(ARCHETYPES[0, L])

GREEN = "#2e7d32"
YELLOW = "#f9a825"
RED = "#c62828"
ROAD = "#9e9e9e"
CAR = "#1565c0"


def lane_to_host(sim: SimState, env_index: int) -> SimState:
    """Lane ``env_index`` of a batched state (or of a tick stack, whose
    leaves keep their leading tick axis) as numpy arrays, fetched in one
    device-to-host copy of its bytes."""
    lane = {k: v[..., env_index].contiguous()
            for k, v in vars(sim).items() if v is not None}
    flat = torch.cat([v.reshape(-1).view(torch.uint8)
                      for v in lane.values()]).cpu()
    out, i = {k: None for k in vars(sim)}, 0
    for k, v in lane.items():
        n = v.numel() * v.element_size()
        out[k] = flat[i:i + n].clone().view(v.dtype).reshape(
            v.shape).numpy()
        i += n
    return SimState(**out)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) \
        else np.asarray(a)


def _road_color(topo: GridRoad, rid: int, phase, elapsed):
    if rid >= topo.train_roads:
        return ROAD
    dst = topo.dest[rid]
    red = topo.phase_group[rid] == phase[dst]
    if red or elapsed[dst] < YELLOW_TICKS:
        return RED if red else YELLOW
    return GREEN


def _snapshot(sim, env_index):
    """cars, leading, lastcar, phase, elapsed of one env as numpy."""
    get = lambda leaf: _host(leaf if env_index is None
                             else leaf[..., env_index])
    return (get(sim.cars), get(sim.leading), get(sim.lastcar),
            get(sim.phase), get(sim.elapsed))


def render_frame(topo: GridRoad, sim, ax=None, env_index: int | None = None):
    """Draw one simulator snapshot onto a matplotlib Axes.  ``sim`` is
    one env's state, or a batched one with ``env_index`` selecting the
    lane; row 0 of the cars is x."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    cars, leading, lastcar, phase, elapsed = _snapshot(sim, env_index)
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    length = topo.length
    for rid in range(topo.roads):
        (x0, y0), (x1, y1) = topo.locs[rid]
        ax.plot([x0, x1], [y0, y1],
                color=_road_color(topo, rid, phase, elapsed),
                linewidth=1.5, zorder=1)
        # occupied ring slots: distance from the leader in [1, ncars]
        ncars = int((lastcar[rid] - leading[rid]) % RING)
        ux, uy = (x1 - x0) / length, (y1 - y0) / length
        for d in range(1, ncars + 1):
            slot = (int(leading[rid]) + d) % RING
            x = float(cars[rid, 0, slot])
            if not np.isfinite(x):
                continue
            a, b = max(x - CAR_LENGTH, 0.0), min(x, length)
            ax.plot([x0 + ux * a, x0 + ux * b],
                    [y0 + uy * a, y0 + uy * b],
                    color=CAR, linewidth=4, solid_capstyle="butt", zorder=2)
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])
    return ax


def save_frame(topo: GridRoad, sim, path: str, env_index: int | None = None):
    import matplotlib.pyplot as plt
    ax = render_frame(topo, sim, env_index=env_index)
    ax.figure.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(ax.figure)
    return path


def _iter_tick_frames(ticks: SimState, env_index: int):
    """One-env frames of a ``step_autoreset_lazy_ticks`` stack (a
    SimState whose leaves have a leading tick axis), fetching only the
    rendered lane, in one copy an agent step."""
    lane = lane_to_host(ticks, env_index)
    for w in range(lane.steps.shape[0]):
        yield SimState(**{k: None if v is None else v[w]
                          for k, v in vars(lane).items()})


class EpisodeRenderer:
    """Collects one frame per agent step (or per tick); writes PNGs, and
    a GIF when pillow is there."""

    def __init__(self, topo: GridRoad, outdir: str, env_index: int = 0):
        self.topo, self.outdir, self.env_index = topo, outdir, env_index
        os.makedirs(outdir, exist_ok=True)
        self.frames: list[str] = []

    def _save(self, frame):
        path = os.path.join(self.outdir, f"frame_{len(self.frames):04d}.png")
        save_frame(self.topo, frame, path)
        self.frames.append(path)
        return path

    def add(self, sim):
        return self._save(lane_to_host(sim, self.env_index))

    def add_ticks(self, ticks):
        """--render_ticks: one frame per simulator tick."""
        for frame in _iter_tick_frames(ticks, self.env_index):
            self._save(frame)

    def finish(self, gif_name: str = "episode.gif", duration_ms: int = 250):
        try:
            from PIL import Image
        except ImportError:
            return None
        if not self.frames:
            return None
        imgs = [Image.open(p) for p in self.frames]
        out = os.path.join(self.outdir, gif_name)
        imgs[0].save(out, save_all=True, append_images=imgs[1:],
                     duration=duration_ms, loop=0)
        return out


_ANSI_OF = {GREEN: "\x1b[32m", YELLOW: "\x1b[93m", RED: "\x1b[31m",
            ROAD: "\x1b[90m"}
_ANSI_CAR = "\x1b[96m"
_ANSI_NODE = "\x1b[37m"


class TermRenderer:
    """--render_live: the episode animated in the terminal as ANSI text,
    from the same snapshots: roads as line cells coloured by their
    light, cars as bright blocks placed by their x along the road,
    opposing directions offset into their own lanes (the ``locs`` lane
    offsets).  The reference redraws every tick of a pyglet window,
    sleeping rate/2 between frames; here the frames are paced by
    ``rate_s`` when the output is a terminal and written at once into a
    file or buffer.  Same ``add``/``add_ticks``/``finish`` surface as
    EpisodeRenderer."""

    def __init__(self, topo: GridRoad, rate_s: float = 0.25,
                 cells_per_road: int = 12, env_index: int | None = 0,
                 out=None):
        import sys
        self.topo, self.rate_s, self.env_index = topo, rate_s, env_index
        self.K = cells_per_road            # horizontal cells per road
        self.Kv = max(cells_per_road // 2, 2)   # rows per road
        self.out = out or sys.stdout
        self.outdir = "<terminal>"   # drivers print "rendered N to {outdir}"
        self.frames: list[int] = []
        self._w = self._cx(topo.n) + 1
        self._h = self._cy(topo.m) + 1

    def _cx(self, gx: float) -> int:
        return int(round((gx + 1) * (self.K + 1)))

    def _cy(self, gy: float) -> int:
        return int(round((gy + 1) * (self.Kv + 1)))

    def _put(self, canvas, cy: int, cx: int, ch: str, color: str):
        if 0 <= cy < self._h and 0 <= cx < self._w:
            canvas[cy][cx] = (ch, color)

    @staticmethod
    def _lane_shift(g: float) -> tuple[int, int]:
        """(snapped grid coordinate, +-1 lane offset in cells) from a
        locs coordinate carrying the lane offset."""
        snap = int(round(g))
        d = g - snap
        return snap, (0 if abs(d) < 1e-6 else (1 if d > 0 else -1))

    def frame_str(self, sim, env_index: int | None = None) -> str:
        """One frame as an ANSI string."""
        cars, leading, lastcar, phase, elapsed = _snapshot(sim, env_index)
        topo, length = self.topo, float(self.topo.length)
        canvas = [[(" ", "")] * self._w for _ in range(self._h)]

        for r in range(topo.m):
            for c in range(topo.n):
                self._put(canvas, self._cy(r), self._cx(c), "┼",
                          _ANSI_NODE)

        for rid in range(topo.roads):
            color = _ANSI_OF[_road_color(topo, rid, phase, elapsed)]
            (x0, y0), (x1, y1) = topo.locs[rid] / length
            horiz = abs(y1 - y0) < 0.25
            if horiz:
                snap, shift = self._lane_shift((y0 + y1) / 2)
                cy = self._cy(snap) + shift
                ca, cb = self._cx(x0), self._cx(x1)
                lo, hi = min(ca, cb), max(ca, cb)
                for cx in range(lo, hi + 1):
                    self._put(canvas, cy, cx, "─", color)
            else:
                snap, shift = self._lane_shift((x0 + x1) / 2)
                cx = self._cx(snap) + shift
                ca, cb = self._cy(y0), self._cy(y1)
                lo, hi = min(ca, cb), max(ca, cb)
                for cy in range(lo, hi + 1):
                    self._put(canvas, cy, cx, "│", color)
            # occupied ring slots, the same walk as render_frame
            ncars = int((lastcar[rid] - leading[rid]) % RING)
            for d in range(1, ncars + 1):
                slot = (int(leading[rid]) + d) % RING
                x = float(cars[rid, 0, slot])
                if not np.isfinite(x):
                    continue
                f = min(max(x / length, 0.0), 1.0)
                if horiz:
                    self._put(canvas, cy, int(round(ca + (cb - ca) * f)),
                              "█", _ANSI_CAR)
                else:
                    self._put(canvas, int(round(ca + (cb - ca) * f)), cx,
                              "█", _ANSI_CAR)

        lines = []
        for row in canvas:
            parts, cur = [], None
            for ch, color in row:
                if color != cur:
                    parts.append("\x1b[0m" if not color else color)
                    cur = color
                parts.append(ch)
            parts.append("\x1b[0m")
            lines.append("".join(parts))
        return "\n".join(lines)

    def _show(self, frame):
        import time
        if not self.frames:
            self.out.write("\x1b[2J")         # clear once
        self.out.write("\x1b[H" + self.frame_str(frame) + "\x1b[0m\n")
        self.out.flush()
        self.frames.append(len(self.frames))
        isatty = getattr(self.out, "isatty", None)
        if self.rate_s and isatty is not None and isatty():
            time.sleep(self.rate_s)

    def add(self, sim):
        """A batched state's lane ``env_index`` (a one-env state as it
        is when ``env_index`` is None)."""
        self._show(sim if self.env_index is None
                   else lane_to_host(sim, self.env_index))

    def add_ticks(self, ticks):
        for frame in _iter_tick_frames(ticks, self.env_index):
            self._show(frame)

    def finish(self, *a, **k):
        return None


def make_renderer(cfg, topo: GridRoad):
    """The renderer of ``--render``: ``TermRenderer`` with
    ``--render_live`` (a frame every rate/2 s with ``--render_ticks``,
    every 0.25 s otherwise), else ``EpisodeRenderer`` into
    ``<logdir>/render``."""
    if cfg.render_live:
        return TermRenderer(topo, rate_s=cfg.rate / 2 if cfg.render_ticks
                            else 0.25)
    return EpisodeRenderer(topo, os.path.join(cfg.logdir, "render"))
