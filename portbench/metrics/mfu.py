"""The whole step's share of the card's bf16 peak, in percent: the model
FLOPs of the window's admissions (real prompt tokens) and decoded tokens,
over the window's seconds, over 989 TFLOP/s.
In a traced run: the part of the window before the profiler starts."""

from portbench.yardstick import PEAK_BF16_FLOPS


def read(run):
    return 100.0 * run.quiet_flops() / run.quiet_s / PEAK_BF16_FLOPS
