"""The sharded CLI of the port on the CPU (gloo): two processes of one
run through ``--coordinator/--num_processes/--process_id/--mesh_shape``
(the counterpart of ``tests/test_multihost.py``), where rank 0 alone
writes the logdir; and a checkpoint saved by two ranks, which holds the
global state, restored in one process to go on training the unsharded
run's program."""

import json
import os
import subprocess
import sys

import torch

from traffic_env_tpu_torch import parallel
from traffic_env_tpu_torch.algorithms import run_alg
from traffic_env_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300


def test_two_process_cli_training(tmp_path):
    """qlearn on two processes of one rank each: both finish; process
    0's logdir has settings.json, the metrics and model.ckpt, process
    1's logdir is never made."""
    port = parallel.dist.free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def proc(pid):
        return subprocess.Popen(
            [sys.executable, "-m", "traffic_env_tpu_torch",
             "--trainer=qlearn", "--platform=cpu",
             f"--coordinator=localhost:{port}", "--num_processes=2",
             f"--process_id={pid}", "--mesh_shape=2", "--num_envs=4",
             "--grid_m=1", "--grid_n=2", "--road_length=60",
             "--episode_secs=20", "--total_episodes=2", "--buffer_size=16",
             "--batch_size=4", "--summary_rate=1", "--validate_rate=5",
             "--save_rate=100", f"--logdir={tmp_path}/p{pid}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    procs = [proc(0), proc(1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    p0 = tmp_path / "p0"
    assert (p0 / "model.ckpt").is_file()
    assert (p0 / "settings.json").is_file()
    assert not (tmp_path / "p1").exists()
    lines = [json.loads(ln) for ln in open(p0 / "metrics.jsonl")]
    assert any(ln["name"] == "mean_reward" and ln["value"] != 0.0
               for ln in lines)


def checkpoint_roundtrip(tmp_path, mesh_shape):
    """qlearn for one episode on ``mesh_shape`` (gloo), saved by rank 0,
    then --restore in one process for a second episode: the parameters,
    the replay and the env state equal those of two episodes in one
    process."""
    kw = dict(trainer="qlearn", platform="cpu", grid_m=1, grid_n=2,
              road_length=60.0, num_envs=8, episode_secs=20,
              buffer_size=32, batch_size=4, validate_rate=100,
              save_rate=100, seed=1)
    ref = run_alg(Config(total_episodes=2, logdir=str(tmp_path / "one"),
                         **kw).derive())
    logdir = str(tmp_path / "two")
    run_alg(Config(mesh_shape=mesh_shape, total_episodes=1, logdir=logdir,
                   **kw).derive())
    sd = torch.load(os.path.join(logdir, "model.ckpt"), weights_only=True)
    assert sd["sim"]["cars"].shape[-1] == 8
    assert sd["replay"]["frames"].shape[1] == 8
    ts = run_alg(Config(restore=True, total_episodes=2, logdir=logdir,
                        **kw).derive())
    assert ts.episode == 2
    a, b = ref.state_dict(), ts.state_dict()
    for name in ("main", "target"):
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), (name, k)
    for k in ("frames", "a", "r", "nd"):
        assert torch.equal(a["replay"][k], b["replay"][k]), k
    for k, v in a["sim"].items():
        if v is not None:
            assert torch.equal(v, b["sim"][k]), k


def test_two_rank_checkpoint_restores_in_one_process(tmp_path):
    checkpoint_roundtrip(tmp_path, "2")


def test_dp_mp_checkpoint_restores_in_one_process(tmp_path):
    """The same on a 2 x 2 mesh: 4 ranks, 2 mp replicas of each dp shard,
    one checkpoint of the global state."""
    checkpoint_roundtrip(tmp_path, "2,2")
