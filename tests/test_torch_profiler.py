"""The port's profiler on the CPU: the sweep on both cores and
the learner throughput print one JSON line with the keys of the JAX
package's ``profiler.py``, ``--trace`` writes a trace with the program's
spans and prints the tracer's table of them, and without
``--platform=cpu`` and without a card it raises."""

import json
import os
import re

import pytest
import torch

from traffic_env_tpu_torch import profiler

JAX_PROFILER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "profiler.py")
# a few agent steps an episode on the 3x3 bench grid
TINY = dict(episode_secs=20)


def jax_keys():
    """The keys of the two ``json.dumps({...})`` rows of the JAX
    package's profiler.py: (sweep keys, training keys)."""
    with open(JAX_PROFILER) as f:
        src = f.read()
    rows = re.findall(r"json\.dumps\(\{(.*?)\}\)", src, re.S)
    return [re.findall(r'"(\w+)":', row) for row in rows]


def printed_row(capsys):
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.mark.parametrize("core", ["window", "fast"])
def test_sweep_prints_the_jax_keys(core, capsys):
    """``--platform=cpu --num_envs=8 --episodes=1`` on the bench config."""
    out = profiler.main(["--platform=cpu", "--num_envs=8", "--episodes=1",
                         f"--core={core}"])
    row = printed_row(capsys)
    assert list(row) == jax_keys()[0]
    assert row == out and row["core"] == core and row["num_envs"] == 8
    assert row["wall_s"] > 0 and row["env_steps_per_sec"] > 0


def test_auto_core_is_the_window(capsys):
    args = profiler.parse_args(["--platform=cpu", "--num_envs=8",
                                "--episodes=1"])
    assert args.core == "auto"
    row, prof = profiler.sweep(args, **TINY)
    assert row["core"] == "window" and prof is None
    with pytest.raises(ValueError, match="--core"):
        profiler.sweep(profiler.parse_args(["--platform=cpu",
                                            "--core=pallas"]), **TINY)


def test_trainer_prints_the_jax_keys(capsys):
    args = profiler.parse_args(["--platform=cpu", "--num_envs=4",
                                "--episodes=1", "--trainer=qlearn"])
    row, _ = profiler.profile_training(args, grid_m=2, grid_n=2,
                                       episode_secs=40, buffer_size=32,
                                       batch_size=4)
    assert printed_row(capsys) == row
    assert list(row) == jax_keys()[1]
    assert row["trainer"] == "qlearn" and row["train_env_steps_per_sec"] > 0


def test_trainer_without_make_state_raises():
    with pytest.raises(ValueError, match="make_state"):
        profiler.main(["--platform=cpu", "--trainer=cem"])


def test_trace_writes_a_trace(tmp_path, capsys):
    """``--trace=DIR``: a Chrome/Perfetto trace of the ops of two
    episodes in DIR/trace.json, the profile returned for key_averages."""
    d = str(tmp_path / "prof")
    args = profiler.parse_args(["--platform=cpu", "--num_envs=8",
                                "--episodes=1", f"--trace={d}"])
    row, prof = profiler.sweep(args, **TINY)
    out = capsys.readouterr().out
    assert f"trace written to {d}" in out
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::add" in names or "aten::add_" in names
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
    # the program's spans, and the tracer's table of them
    assert {"env.step", "env.window", "env.shape"} <= {
        e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert span_rows(out) >= {"env.step", "env.window", "env.shape"}


def span_rows(out):
    """The span names of the tracer's table in printed ``out``."""
    lines = out.splitlines()
    head = [i for i, l in enumerate(lines) if l.split()[:2] == ["span",
                                                              "count"]]
    assert len(head) == 1 and lines[head[0]].split()[2:] == \
        ["host", "ms", "self", "ms", "device", "ms"]
    return {l.split()[0] for l in lines[head[0] + 1:] if l.strip()}


def test_trainer_trace_prints_the_qlearn_spans(tmp_path, capsys):
    """``--trainer=qlearn --trace=DIR``: the episode's ``qlearn.*`` and
    ``env.*`` spans in DIR/trace.json and in the printed table."""
    d = str(tmp_path / "prof")
    args = profiler.parse_args(["--platform=cpu", "--num_envs=4",
                                "--episodes=1", "--trainer=qlearn",
                                f"--trace={d}"])
    profiler.profile_training(args, grid_m=2, grid_n=2, episode_secs=40,
                              buffer_size=32, batch_size=4)
    out = capsys.readouterr().out
    want = {"qlearn.act", "qlearn.insert", "qlearn.sgd", "env.step"}
    assert span_rows(out) >= want
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert want <= {e.get("name") for e in events
                    if e.get("cat") == "user_annotation"}


def test_the_card_is_the_default(monkeypatch):
    """Without --platform=cpu the profiler runs on the card, and raises
    without one: the CPU never stands in for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler.main(["--num_envs=8", "--episodes=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler.main(["--num_envs=4", "--episodes=1", "--core=fast"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler.main(["--num_envs=4", "--episodes=1", "--trainer=qlearn"])
