"""No module that the harness or the reference imports has the top-level
name jax, jaxlib, flax or traffic_env_tpu (names compared whole: the
port's own name begins with the JAX package's), and the reference
imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT
REFERENCE = os.path.join(ROOT, "benchmark", "reference")


def test_names_are_compared_whole():
    mods = ["traffic_env_tpu_torch", "traffic_env_tpu_torch.ops.window",
            "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_loaded(mods) == []
    assert harness.forbidden_loaded(mods + ["traffic_env_tpu.envs.env"]) \
        == ["traffic_env_tpu"]
    assert harness.forbidden_loaded(["jax.numpy", "jaxlib.xla_client",
                                     "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]


def loaded_after(code: str) -> set:
    """Top-level module names loaded in a fresh interpreter after
    ``code`` runs from the root of the checkout."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_drivers_load_nothing_of_jax():
    names = [m["name"] for m in json.load(open(os.path.join(
        ROOT, "BENCHMARK.json")))["per_layer"]]
    code = ("import benchmark.harness as h, benchmark.calibrate, "
            "benchmark.drivers.sim, benchmark.drivers.learner\n"
            "import traffic_env_tpu_torch.algorithms.a3c\n"
            f"[h.reader(n) for n in {names!r}]")
    loaded = loaded_after(code)
    assert not loaded.intersection(harness.FORBIDDEN), loaded


def test_reference_imports_nothing_of_the_program():
    loaded = loaded_after("import benchmark.reference.sim, "
                          "benchmark.reference.a3c")
    assert not loaded.intersection(harness.FORBIDDEN)
    assert "traffic_env_tpu_torch" not in loaded
    for name in os.listdir(REFERENCE):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REFERENCE, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]] \
                    if node.level == 0 else ["benchmark"]
            else:
                continue
            assert set(tops) <= {"numpy", "torch", "__future__", "math",
                                 "benchmark"}, (name, tops)
