"""The metrics' arithmetic on fixed inputs: rates over the whole window,
the p95 over every step, the roofline bytes and operations, the FLOP
counts, and the trace's reduction."""

import math

import pytest

from benchmark import readers, roofline, stats, trace


def test_rate_is_all_work_over_all_seconds():
    assert stats.rate(3000 * 10 * 32768, 10.0) == 3000 * 32768
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_is_nearest_rank_over_every_sample():
    vals = list(range(1, 101))               # 1 .. 100
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile([5.0, 1.0, 3.0], 95) == 5.0
    assert stats.percentile([2.0] * 19 + [9.0], 95) == 2.0
    assert stats.percentile([2.0] * 18 + [9.0, 9.0], 95) == 9.0


def test_window_bytes_counts_cars_and_planes_once_each_way():
    R, Rt, I, B = 48, 36, 9, 2
    got = roofline.window_bytes(R, Rt, I, B, 100, 120)
    car = 12 * (100 + 120 + 2 * R * B)
    ints = B * (4 * (2 * 48 + 2 * 9 + 2 * 36 + 4) + 9 + 1)
    assert got == car + 2 * ints + B * 4 + I * B * 4 + (2 * Rt + 2 * I) * B * 4
    # linear in the cars: one count of all windows equals the sum
    assert roofline.window_bytes(R, Rt, I, B, 30, 50) \
        + roofline.window_bytes(R, Rt, I, B, 70, 70) == pytest.approx(
            roofline.window_bytes(R, Rt, I, B, 100, 120)
            + roofline.window_bytes(R, Rt, I, B, 0, 0))
    assert roofline.window_ops(100, 120, 10) == 110 * 10 * 37


def test_least_time_takes_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert roofline.least_seconds(3.35e9, 134e12) == pytest.approx(2.0)


def test_conv_flops_of_the_learner():
    assert roofline.conv_flops(2, 5, 5, 3, 4, 3) == 2 * 2 * 25 * 3 * 4 * 9
    b, m, n, c, h = 2048, 5, 5, 260, 32
    policy = 3 * 2 * b * 25 * (h + c) * h * 9 + 2 * 2 * b * 25 * h
    teacher = (2 * b * 25 * c * 64 * 9 + 2 * 2 * b * 25 * 64 * 64 * 9
               + 2 * b * 25 * 64 * 2)
    assert roofline.convgru_step_flops(b, m, n, c, h) == policy
    assert roofline.convq_flops(b, m, n, c) == teacher
    T = 30
    assert roofline.a3c_window_flops(b, T, m, n, c, True, h) == \
        T * (policy + teacher) + policy + 3 * T * policy
    assert roofline.a3c_window_flops(b, T, m, n, c, False, h) == \
        T * policy + policy + 3 * T * policy


def test_kernel_names_lose_type_and_arguments():
    assert trace.kernel_name("void window_kernel<false, false, false>"
                             "(WindowArgs)") == \
        "window_kernel<false,false,false>"
    assert trace.kernel_name("ampere_sgemm_128x64_nn") == \
        "ampere_sgemm_128x64_nn"


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary_unions_busy_time_and_names_gaps():
    events = [
        ev("kernel", "void window_kernel<false, false, false>(WindowArgs)",
           0, 100),
        ev("kernel", "void elementwise(int)", 50, 100),     # overlaps
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 300, 50),
        ev("kernel", "void window_kernel<false, false, false>(WindowArgs)",
           400, 100),
        ev("cpu_op", "aten::to", 140, 170),                  # spans gap 1
        ev("cuda_runtime", "cudaMemcpyAsync", 360, 45),      # spans gap 2
        ev("cpu_op", "aten::copy_", 355, 60),
    ]
    t = trace.summarize(events, window_s=1e-3)
    assert t.busy_s == pytest.approx((150 + 50 + 100) * 1e-6)
    assert t.launches == 3
    assert t.copy_s == pytest.approx(50e-6)
    assert t.kernel("window_kernel") == (pytest.approx(200e-6), 2)
    gaps = dict(t.gaps)
    assert gaps["aten::to"] == pytest.approx(150e-6)
    assert gaps["aten::copy_"] == pytest.approx(50e-6)
    br = t.breakdown()
    assert br["device_ops"][0][0] == "window_kernel<false,false,false>"


def test_readers_on_fixed_readings():
    t = trace.Trace(window_s=0.01, busy_s=0.008,
                    by_kernel={"window_kernel<false,false,false>":
                               [0.006, 2], "other": [0.002, 8]},
                    copy_s=0.001, launches=10, gaps=[])
    r = {"trace": t, "steps": 2, "window_bytes": 3.35e9,
         "window_ops": 0.0}
    assert readers.window_ms(r) == pytest.approx(3.0)
    # 1 ms of least time over 6 ms of kernel, over 10 ms of window
    assert readers.window_roofline(r) == pytest.approx(100 / 6)
    assert readers.sim_step_mfu(r) == pytest.approx(10.0)
    assert readers.launches_per_step(r) == 5
    assert readers.copy_ms(r) == pytest.approx(0.5)
    assert readers.idle_share(r) == pytest.approx(20.0)
    learner = {"flops": 67e12, "timed_s": 2.0, "rollout_s": [0.1, 0.3]}
    assert readers.learner_step_mfu(learner) == pytest.approx(50.0)
    assert readers.span_ms("rollout_s")(learner) == pytest.approx(200.0)


def test_readers_find_nothing_without_device_work():
    empty = trace.Trace(0.01, 0.0, {}, 0.0, 0, [])
    r = {"trace": empty, "steps": 2, "window_bytes": 1.0, "window_ops": 1.0}
    for fn in (readers.window_ms, readers.window_roofline,
               readers.sim_step_mfu, readers.launches_per_step,
               readers.copy_ms, readers.idle_share):
        assert fn(r) is None
    assert readers.learner_step_mfu({}) is None
    assert readers.span_ms("update_s")({}) is None
    assert not math.isnan(readers.idle_share(
        {"trace": trace.Trace(0.01, 0.02, {}, 0.0, 1, [])}))
