"""The whole fit's share of the card's peak, in %: the model's FLOPs per
fit at the cell's shapes (`portbench/counts.py`, by the driver's
`flops_per_fit`) times the fits of the window, over the window's wall
time, over the peak of the precision the work runs in (float32 without
TF32, 67 TFLOP/s on an H100 SXM)."""

from portbench import counts, harness


def read(run):
    if not run.records or run.window_s <= 0:
        return None
    drv = harness.driver(run.traffic["driver"])
    flops = drv.flops_per_fit(run) * len(run.records)
    return 100.0 * flops / run.window_s / counts.PEAK_FP32
