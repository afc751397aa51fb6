"""The on-card bit-parity gate of the CUDA window kernel (counterpart of
``parity_tpu.py``).

    python -m traffic_env_tpu_torch.parity                  # on the card
    python -m traffic_env_tpu_torch.parity --platform=cpu   # plumbing only

Every headline number rides the CUDA window kernel (``csrc/window.cu``),
while the CPU tests run its plain PyTorch version.  This gate runs the
kernel env (``make_batched_env(core="window")``) and the per-tick torch
env (``core="fast"``, W ticks of ``fast_core.tick`` a step) side by side
on the card, over whole episodes with schedule-driven spawns, ring
overflows, the window's lazy autoreset and validate-mode telemetry: obs,
reward and done bit-equal every window (and with telemetry the light
times and the trip histogram), and the final ``SimState`` bit-equal.
Both sides run their production lazy step, ``step_autoreset_lazy``.

Three scenarios: the bench workload (3x3, 256 envs, random actions,
``--windows`` windows, two episodes by default), an overflow storm (1x1
of 40 m roads, dense arrivals, all red, 128 envs, 50 windows) and the
validate mode (3x3, 128 envs, 60 windows).  Writes ``--out``
(``PARITY_H100.json``), prints it, and exits 0 only when every scenario
is bit-equal on the card.  On the CPU both sides run the same tick
body, so ``--platform=cpu`` checks the gate's plumbing only; it exits 0
when every scenario is equal, with ``ok`` false.

Without a card and without ``--platform=cpu`` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from .algorithms.common import device_of
from .config import Config, derive_spawn_rate
from .envs.rollout import bind_schedule, make_batched_env
from .envs.spawn import build_batched_schedule
from .interop import schedule_from_arrays
from .topology import GridRoad

CLAIM = ("CUDA window kernel == torch fast core on the card, bit-exact "
         "obs/reward/done per window + final SimState, schedule-driven "
         "spawns, lazy autoresets + overflows + validate telemetry "
         "included")


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def tree_mismatch(a, b, exclude=()):
    """The first leaf that differs between two states (dataclasses or
    dicts; ``None`` and ``exclude`` leaves skipped), as ``{"leaf",
    "n_bad", "max_abs"}``, or None when every leaf is equal."""
    def as_map(x):
        if dataclasses.is_dataclass(x):
            x = {f.name: getattr(x, f.name)
                 for f in dataclasses.fields(x)}
        return {k: v for k, v in x.items()
                if v is not None and k not in exclude}
    fa, fb = as_map(a), as_map(b)
    for k in fa:
        x, y = _numpy(fa[k]), _numpy(fb[k])
        if not np.array_equal(x, y):
            return {"leaf": k, "n_bad": int(np.sum(x != y)),
                    "max_abs": float(np.max(np.abs(
                        x.astype(np.float64) - y.astype(np.float64))))}
    return None


def run_scenario(name, topo, cfg, n_envs, n_windows, actions_fn, device,
                 compare_info=False, max_spawns=8, seed0=100):
    """One scenario: the window env and the per-tick env on ``device``,
    each bound to one schedule of ``n_envs`` envs (seeds ``seed0 + i``),
    from one ``init`` (a generator seeded 5; the window side gets a
    clone, since the window writes its state in place), reset, then
    ``n_windows`` lazy-autoreset steps on the actions ``actions_fn(rng,
    t)`` of a ``RandomState(7)``.  Stops at the first mismatch.  Returns
    ``{"name", "envs", "windows", "ok", "mismatch", "done_lanes_reset",
    "wall_s"}``."""
    dev = torch.device(device)
    seeds = [seed0 + i for i in range(n_envs)]
    n_ticks = (n_windows + cfg.history + 4) * cfg.light_iterations
    kw = dict(on_device_spawns=False, max_spawns_per_tick=max_spawns,
              device=dev)
    fast = make_batched_env(topo, cfg, n_envs, core="fast", **kw)
    win = make_batched_env(topo, cfg, n_envs, core="window", **kw)
    sched = schedule_from_arrays(build_batched_schedule(
        topo, cfg, seeds, n_ticks, max_spawns), dev)
    fast, win = bind_schedule(fast, sched), bind_schedule(win, sched)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    sf = fast.init(gen)
    sw = sf.clone()
    sf, _ = fast.reset(sf)
    sw, _ = win.reset(sw)

    rng = np.random.RandomState(7)
    resets_seen = 0
    result = {"name": name, "envs": n_envs, "windows": n_windows,
              "ok": True, "mismatch": None}
    t0 = time.perf_counter()
    for t in range(n_windows):
        a = torch.as_tensor(actions_fn(rng, t), device=dev)
        sf, of, rf, df, inf_f = fast.step_autoreset_lazy(sf, a)
        sw, ow, rw, dw, inf_w = win.step_autoreset_lazy(sw, a)
        pairs = [(what, _numpy(x), _numpy(y)) for what, x, y in
                 (("obs", of, ow), ("reward", rf, rw), ("done", df, dw))]
        resets_seen += int(pairs[2][2].sum())
        for what, x, y in pairs:
            if not np.array_equal(x, y):
                result.update(ok=False, mismatch={
                    "window": t, "what": what,
                    "n_bad": int(np.sum(x != y)),
                    "max_abs": float(np.max(np.abs(
                        x.astype(np.float64) - y.astype(np.float64))))})
                break
        if compare_info and result["ok"]:
            lt = tree_mismatch({"light_times": inf_f["light_times"],
                                "trip_hist": sf.sim.trip_hist},
                               {"light_times": inf_w["light_times"],
                                "trip_hist": sw.sim.trip_hist})
            if lt is not None:
                result.update(ok=False,
                              mismatch={"window": t, "what": "info", **lt})
        if not result["ok"]:
            break
    if result["ok"]:
        mm = tree_mismatch(sf.sim, sw.sim)
        if mm is not None:
            result.update(ok=False,
                          mismatch={"window": "final_state", **mm})
    result["done_lanes_reset"] = resets_seen
    result["wall_s"] = round(time.perf_counter() - t0, 2)
    return result


def scenario_config(m: int, n: int, length: float, **kw):
    """(topology, config) of a scenario: ``Config(grid_m=m, grid_n=n,
    road_length=length, **kw).derive()`` with the grid's spawn rate."""
    topo = GridRoad(m, n, length)
    cfg = Config(grid_m=m, grid_n=n, road_length=length, **kw).derive()
    return topo, derive_spawn_rate(cfg, topo.open_sides(0))


def _random_actions(rng, I, B):
    return rng.randint(2, size=(I, B)).astype(np.int32)


def _all_red(rng, I, B):
    return np.zeros((I, B), np.int32)


# name: (grid, config overrides, envs, windows (None: --windows),
# actions, max spawns a tick, compare the telemetry).  The default
# trainer, qlearn, derives history 20 from these configs, as in
# parity_tpu.py: the reset runs 20 windows.
SCENARIOS = {
    # the bench workload: 3x3, random actions, lazy autoreset
    "bench_3x3_random": ((3, 3, 250.0), dict(history=1), 256, None,
                         _random_actions, 16, False),
    # 1x1 short roads, dense arrivals, all red: ring overflows and lazy
    # resets every few windows
    "overflow_1x1_allred": ((1, 1, 40.0), dict(
        history=1, local_cars_per_sec=0.8), 128, 50, _all_red, 24, False),
    # validate-mode telemetry: light times and trip histograms
    "validate_3x3_telemetry": ((3, 3, 250.0), dict(
        history=1, mode="validate"), 128, 60, _random_actions, 16, True),
}


def scenario(name: str, device, windows: int = 240, envs: int | None = None,
             n_windows: int | None = None) -> dict:
    """Runs scenario ``name`` of :data:`SCENARIOS` on ``device``;
    ``windows`` is the bench scenario's window count, ``envs`` and
    ``n_windows`` override its size (a smaller run)."""
    grid, kw, B, W_, act, max_spawns, info = SCENARIOS[name]
    topo, cfg = scenario_config(*grid, **kw)
    B = envs or B
    n = n_windows or W_ or windows
    I = topo.intersections
    return run_scenario(name, topo, cfg, B, n,
                        lambda rng, t: act(rng, I, B), device,
                        compare_info=info, max_spawns=max_spawns)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _commit() -> str:
    """``git rev-parse --short HEAD`` of the checkout this module is in;
    "" outside a git checkout."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=root,
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def report(scenarios: list, device, path: str) -> dict:
    """The gate's JSON for the scenario results on ``device``, written to
    ``path``: ``ok`` only when every scenario is equal on the card."""
    on_chip = torch.device(device).type == "cuda"
    out = {
        "ok": all(s["ok"] for s in scenarios) and on_chip,
        "on_chip": on_chip,
        "device": _card() if on_chip else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "commit": _commit(),
        "claim": CLAIM,
        "scenarios": scenarios,
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None) -> int:
    """Runs the gate, writes and prints its JSON; returns the exit code."""
    p = argparse.ArgumentParser(
        description="the CUDA window kernel against the torch fast core, "
                    "bit for bit")
    p.add_argument("--platform", type=str, default="",
                   help="'' or cuda: the card; cpu: the CPU (plumbing "
                        "only: both sides run the same tick body)")
    p.add_argument("--windows", type=int, default=240,
                   help="bench-scenario windows (240 = 2 episodes)")
    p.add_argument("--out", type=str, default="PARITY_H100.json")
    args = p.parse_args(argv)
    dev = device_of(Config(platform=args.platform))
    out = report([scenario(name, dev, args.windows) for name in SCENARIOS],
                 dev, args.out)
    print(json.dumps(out), flush=True)
    all_ok = all(s["ok"] for s in out["scenarios"])
    return 0 if out["ok"] or (not out["on_chip"] and all_ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
