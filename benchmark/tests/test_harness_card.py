"""On the card (marked ``gpu``; skipped without one): a small learner run
and a small simulator run are correct, and their controls, the plain
reference in the nearest lower precision in the program's place, are
not.  Run on the card with::

    python -m pytest benchmark/tests/test_harness_card.py -q -m gpu
"""

import pytest

from benchmark.drivers import learner, sim

from conftest import small_learner, small_sim


def failed(checks: dict) -> bool:
    return any(v > lim for v, lim in checks.values())


@pytest.mark.gpu
def test_learner_tf32_control_fails_on_card(card):
    cell = small_learner()
    cell = cell._replace(config=dict(cell.config, num_envs=64, batch_size=8))
    r = learner.LearnerRun(cell, 2 ** 31 + 41, card)
    r.setup()
    checks, ctl = r.check(control=True)
    assert not failed(checks)
    assert failed(ctl)


@pytest.mark.gpu
def test_sim_bf16_control_fails_on_card(card):
    r = sim.SimRun(small_sim("grid3x3-random-32k", envs=256), 2 ** 31 + 43,
                   card)
    state = r.setup()
    starts = sim.segment_starts(r.seed, 4, 2, r.L)
    r.window(state, steps=8, starts=starts)
    r.planned = len(starts)
    assert not failed(r.check())
    assert failed(r.control())
