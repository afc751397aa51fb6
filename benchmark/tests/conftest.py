"""Cells of the benchmark cut to sizes a CPU test run holds (a few envs,
a few steps); the harness, the references and the drivers are the ones
the card runs."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def small_sim(name: str, envs: int = 48):
    cell = harness.load_cell(name)
    return cell._replace(
        config=dict(cell.config, num_envs=envs),
        traffic=dict(cell.traffic, fill_steps=4, sample_envs=12,
                     check_horizon=4, trace_steps=6))


def small_learner():
    cell = harness.load_cell("a3c-convgru-5x5-2k")
    return cell._replace(
        config=dict(cell.config, num_envs=6, batch_size=4, episode_secs=60),
        traffic=dict(cell.traffic, sample_envs=3, span_windows=1,
                     trace_windows=1))


@pytest.fixture
def threads():
    """Four torch threads for the test, as CPU products round by the
    thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA card, or a skip when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
