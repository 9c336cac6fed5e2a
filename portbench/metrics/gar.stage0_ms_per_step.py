"""Stage 0's wall milliseconds per Adam step over the window's GAR fits
(4 x 2048 rows through the tracked Kronecker NLML): the stage's
synchronized wall at the trainer's ``record_stage`` hook over its steps,
read as `fit.stage0_ms_per_step` reads it (restart trainer, `train/fit.py`
under `train_GAR`)."""

from portbench import harness


def read(run):
    return harness.metric_reader("fit.stage0_ms_per_step").read(run)
