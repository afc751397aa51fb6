"""The yardstick: the peaks of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense rates), the bytes and operations the window kernel must
move and do, and the FLOPs of the conv-GRU learner's nets, all counted
from shapes and from the cars the state holds, never from how a kernel
works."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12          # float32 off the tensor cores
PEAK_TF32_PER_S = 495e12
PEAK_BF16_PER_S = 989e12
PEAKS = {"float32": PEAK_F32_PER_S, "tf32": PEAK_TF32_PER_S,
         "bfloat16": PEAK_BF16_PER_S}
# float operations of one car in one tick of the IDM update
# (multiplies, divides, adds, clamps and compares)
IDM_OPS_PER_CAR_TICK = 37
SLOT_BYTES = 12                 # a car slot: x, v, w in float32


def window_bytes(R: int, Rt: int, I: int, B: int, cars_read: float,
                 cars_written: float) -> float:
    """Bytes one window of ``B`` envs must move, each read once and
    written once: the car slots it reads (the cars of the lanes that do
    not start it done) and writes (the cars that end it), each road's
    fake-leader slot, the integer planes (leading, lastcar, phase,
    elapsed, waiting, detected, passed_dst, gap, backlog, steps, global
    tick, done) both ways, the seed and the action in, the four window
    outputs out."""
    car = SLOT_BYTES * (cars_read + cars_written + 2 * R * B)
    ints = B * (4 * (2 * R + 2 * I + 2 * Rt + 4) + I + 1)
    inputs = B * 4 + I * B * 4
    outputs = (2 * Rt + 2 * I) * B * 4
    return car + 2 * ints + inputs + outputs


def window_ops(cars_read: float, cars_written: float, W: int) -> float:
    """The IDM's float operations of one window: the cars it holds, on
    average over its W ticks."""
    return (cars_read + cars_written) / 2 * W * IDM_OPS_PER_CAR_TICK


def least_seconds(n_bytes: float, n_ops: float,
                  peak_ops: float = PEAK_F32_PER_S) -> float:
    """The least time the chip could take: the larger of the bytes at
    the bandwidth and the operations at the peak."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops)


def conv_flops(b: int, h: int, w: int, c_in: int, c_out: int,
               k: int) -> float:
    """Multiply-adds of a SAME convolution, counted as two FLOPs."""
    return 2.0 * b * h * w * c_in * c_out * k * k


def convgru_step_flops(b: int, m: int, n: int, c_in: int,
                       hidden: int = 32) -> float:
    """One forward step of the conv-GRU policy: three 3x3 gate
    convolutions over the state and input channels, two 1x1 heads."""
    return (3 * conv_flops(b, m, n, hidden + c_in, hidden, 3)
            + 2 * conv_flops(b, m, n, hidden, 1, 1))


def convq_flops(b: int, m: int, n: int, c_in: int, channels: int = 64,
                choices: int = 2) -> float:
    """One forward of the ConvQNet teacher: three 3x3 convolutions and
    the 1x1 head."""
    return (conv_flops(b, m, n, c_in, channels, 3)
            + 2 * conv_flops(b, m, n, channels, channels, 3)
            + conv_flops(b, m, n, channels, choices, 1))


def a3c_window_flops(b: int, T: int, m: int, n: int, c_in: int,
                     teacher: bool, hidden: int = 32) -> float:
    """The model FLOPs of one a3c window: the rollout's T policy
    forwards (and the teacher's, where the anchor needs it), the
    bootstrap forward, and the update's replay of T steps with its
    backward at twice the forward."""
    policy = convgru_step_flops(b, m, n, c_in, hidden)
    rollout = T * (policy + (convq_flops(b, m, n, c_in) if teacher else 0))
    return rollout + policy + 3 * T * policy
