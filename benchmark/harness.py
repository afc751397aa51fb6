"""One run of one cell: read the cell, its configuration and its traffic
mix from ``BENCHMARK.json`` by name, run the traffic's driver on the
card, read the cell's metrics, check that nothing of JAX was loaded,
and print the result as the last line of stdout.

Everything a cell needs is data found by name: ``configs[].file``, the
mix ``benchmark/traffic/<traffic>.json`` (whose ``driver`` names one of
the general drivers in ``benchmark/drivers/``) and one reader
``benchmark/metrics/<metric>.py`` per per-layer metric.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "traffic_env_tpu")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict             # the configuration file's contents
    traffic: dict            # the mix's parameters
    end_to_end: list         # the BENCHMARK.json entries the cell reports
    per_layer: list


class Outcome(NamedTuple):
    """What a driver hands back: the end-to-end values by name, the
    readings the per-layer readers take, the numbers compared with their
    limits, the work attempted and failed, the device block, what the
    comparison covered (counts by name), and the forbidden top-level
    names loaded in the run's other processes."""
    e2e: dict
    readings: dict
    checks: dict             # name -> (value, limit)
    attempted: int
    failed: int
    device: dict
    breakdown: dict | None = None
    coverage: dict | None = None
    forbidden: tuple = ()


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry.get("moves") in reported


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                     f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def reader(metric: str, root: str = ROOT):
    """The ``read(readings)`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names.intersection(FORBIDDEN))


def metric_values(cell: Cell, out: Outcome, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` 0) or per-layer metrics
    (``trace`` 1) by name with their units; a reader that finds nothing
    leaves its metric out."""
    res = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] not in out.e2e:
                raise RuntimeError(f"the driver gave no {m['name']}")
            res[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
        return res
    for m in cell.per_layer:
        v = reader(m["name"])(out.readings)
        if v is not None:
            res[m["name"]] = {"value": v, "unit": m["unit"]}
    return res


def result_line(cell: Cell, out: Outcome, trace: bool) -> dict:
    correct = all(v <= lim for v, lim in out.checks.values())
    line = {"correct": bool(correct and out.checks),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metric_values(cell, out, trace),
            "device": out.device}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    if out.coverage:
        line["coverage"] = out.coverage
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    return p.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     t_start, "cuda")
    return finish(cell, out, bool(args.trace))


def finish(cell: Cell, out: Outcome, trace: bool) -> int:
    """Print the run's result line, or, where this process or another
    of the run's processes loaded a forbidden module, name it on stderr
    and print no result (exit code 3)."""
    bad = sorted(set(forbidden_loaded()).union(out.forbidden))
    if bad:
        print(f"loaded in the run: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(cell, out, trace)
    for k, v in (line.get("coverage") or {}).items():
        print(f"coverage {k} {v!r}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
