"""The program's spans in a benchmark run (``benchmark/spans.py``): the
device's idle gaps put down to the innermost program span on a
synthetic Chrome trace, each reading on hand-made passes (None, never 0,
where the pass has nothing to read), and on the card (marked ``gpu``;
skipped without one) the tracer's pass over a small simulator and
learner window with phase cycles and event times.  Run the card's with::

    python -m pytest benchmark/tests/test_spans.py -q -m gpu
"""

import pytest

from benchmark import spans

from conftest import small_learner, small_sim


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_gaps_go_to_the_innermost_span_over_their_middle():
    events = [
        ev("user_annotation", "env.step", 0, 100),     # outer: 0-5 too
        ev("user_annotation", "env.window", 10, 30),   # inner, in env.step
        ev("user_annotation", "Optimizer.step", 50, 10),  # not the program's
        ev("cpu_op", "aten::add", 0, 300),
        ev("kernel", "k", 5, 5),        # gap 10-20 under env.window
        ev("kernel", "k", 20, 30),      # gap 50-60 under env.step only
        ev("gpu_memcpy", "m", 60, 10),  # gap 70-200 outside: env.step ends
        ev("kernel", "k", 200, 50),     # then 250-300 to the last host event
        ev("user_annotation", "env.shape", 240, 60),
        {"ph": "i", "cat": "kernel", "ts": 100},       # not a span
    ]
    names = {"env.step", "env.window", "env.shape"}
    got = spans.idle_by_span(events, names)
    assert got == pytest.approx({"env.window": 10e-6, "env.step": 15e-6,
                                 spans.OUTSIDE: 130e-6,
                                 "env.shape": 50e-6})
    # before the first device interval: from the first host event
    got = spans.idle_by_span([ev("cpu_op", "a", 0, 10),
                              ev("kernel", "k", 4, 6)], names)
    assert got == pytest.approx({spans.OUTSIDE: 4e-6})
    assert spans.idle_by_span([ev("cpu_op", "a", 0, 10)], names) == {}


def snap(spans_=None, counters=None, cycles=None):
    return {"spans": spans_ or {}, "counters": counters or {},
            "phase_cycles": cycles or {}}


def span(count, device_s=()):
    return {"count": count, "host_s": 1.0, "self_s": 0.5,
            "device_s": list(device_s)}


def test_readings_of_a_pass():
    sim = {"snapshot": snap(
        {"env.step": span(2, [3e-3, 3e-3]), "env.shape": span(2, [1e-4,
                                                                  3e-4])},
        {"window.block_ticks": 10}, {"idm": 50, "stage": 20, "store": 5,
                                     "cross": 1}),
        "idle_s": {"env.window": 1e-3, "env.step": 2e-3,
                   spans.OUTSIDE: 5e-3}}
    assert spans.window_idm_cycles(sim) == 5.0
    assert spans.window_stage_cycles(sim) == 2.5
    assert spans.shape_ms(sim) == pytest.approx(0.2)
    assert spans.idle_program_ms(sim) == pytest.approx(1.5)
    learner = {"snapshot": [snap({
        "a3c.rollout": span(2), "a3c.teacher": span(60, [1e-3] * 60),
        "a3c.update.loss": span(2, [0.1, 0.2]),
        "a3c.update.backward": span(2, [0.3, 0.4]),
        "a3c.update.allreduce": span(2, [0.01, 0.002])}), snap({
            "a3c.update.allreduce": span(2, [0.004, 0.003])})],
        "idle_s": {}}
    assert spans.update_fwd_ms(learner) == pytest.approx(150)
    assert spans.update_bwd_ms(learner) == pytest.approx(350)
    assert spans.teacher_ms(learner) == pytest.approx(30)
    assert spans.allreduce_wait_ms(learner) == pytest.approx(
        (6 + 1) / 2)


@pytest.mark.parametrize("name", sorted(spans.READINGS))
def test_a_reading_with_nothing_to_read_is_none(name):
    read = spans.READINGS[name]
    assert read(None) is None
    # a pass on the CPU: spans and counts, no device times or cycles
    cpu = {"snapshot": [snap({k: span(2) for k in (
        "env.step", "env.shape", "a3c.rollout", "a3c.teacher",
        "a3c.update.loss", "a3c.update.backward",
        "a3c.update.allreduce")})] * 2, "idle_s": {}}
    assert read(cpu) is None
    assert read({"snapshot": snap(), "idle_s": {}}) is None


def test_allreduce_wait_of_two_ranks():
    """Per update the slowest rank's all-reduce less the fastest's,
    averaged; one rank alone, or ranks with unlike counts, read None."""
    def ranks(*device_s):
        return {"snapshot": [snap({"a3c.update.allreduce": span(len(d), d)})
                             for d in device_s], "idle_s": {}}
    two = ranks([0.004, 0.001], [0.0015, 0.003])
    assert spans.allreduce_wait_ms(two) == pytest.approx(
        ((0.004 - 0.0015) + (0.003 - 0.001)) / 2 * 1e3)
    assert spans.allreduce_wait_ms(ranks([0.004, 0.001])) is None
    assert spans.allreduce_wait_ms(ranks([0.004, 0.001], [0.002])) is None


@pytest.mark.gpu
def test_sim_pass_on_card(card):
    from traffic_env_tpu_torch.ops.window_cuda import PHASES
    from benchmark.drivers.sim import SimRun
    cell = small_sim("grid3x3-random-32k", envs=256)
    r = SimRun(cell, 2 ** 31 + 47, card)
    state = r.setup()
    steps = int(cell.traffic["trace_steps"])
    sp = spans.traced_spans(lambda: r.window(state, steps=steps), r.sync)
    s = sp["snapshot"]
    assert set(s["phase_cycles"]) == set(PHASES)
    assert sum(s["phase_cycles"].values()) > 0
    assert spans.window_idm_cycles(sp) > 0
    assert s["counters"]["window.launches"] == steps
    for k in ("env.step", "env.window", "env.shape"):
        d = s["spans"][k]["device_s"]
        assert len(d) == steps and min(d) > 0
    assert spans.mean_ms(sp, "env.window") + spans.mean_ms(sp, "env.shape") \
        <= spans.mean_ms(sp, "env.step") * 1.0001


@pytest.mark.gpu
def test_learner_pass_on_card(card):
    from benchmark.drivers.learner import LearnerRun
    cell = small_learner()
    cell = cell._replace(config=dict(cell.config, num_envs=64, batch_size=8))
    r = LearnerRun(cell, 2 ** 31 + 53, card)
    r.setup()
    sp = spans.traced_spans(lambda: r.fns.run_window(r.ts), r.sync)
    assert sp["window_s"] > sp["busy_s"] > 0
    update = spans.mean_ms(sp, "a3c.update")
    kids = [spans.mean_ms(sp, f"a3c.update.{k}")
            for k in ("loss", "backward", "allreduce", "step")]
    assert update > 0 and spans.mean_ms(sp, "a3c.rollout") > 0
    assert min(kids) > 0 and sum(kids) <= update * 1.0001
    assert sum(sp["snapshot"]["phase_cycles"].values()) > 0
    for k in ("update_fwd_ms.a3c", "update_bwd_ms.a3c", "teacher_ms.a3c"):
        assert spans.READINGS[k](sp) > 0
