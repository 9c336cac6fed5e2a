"""The whole GAR fit's share of the card's float64 peak, in %: the model's
operations per fit at the cell's shapes (`portbench/counts_gar.py`, by the
driver's `flops_per_fit`: each mode's eigendecomposition at 9 n^3, the
targets' rotations, the Gram cotangents, the Grams, the posterior) times
the fits of the window, over the window's wall time, over 67 TFLOP/s (an
H100 SXM's float64 tensor-core peak; the Grams and eigendecompositions run
in float64)."""

from portbench import counts_gar, harness


def read(run):
    if not run.records or run.window_s <= 0:
        return None
    drv = harness.driver(run.traffic["driver"])
    flops = drv.flops_per_fit(run) * len(run.records)
    return 100.0 * flops / run.window_s / counts_gar.PEAK_FP64
