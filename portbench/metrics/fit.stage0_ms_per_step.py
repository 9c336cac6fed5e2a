"""Stage 0's wall milliseconds per Adam step, over the window's fits: the
stage's synchronized wall at the trainer's ``record_stage`` hook over its
steps (restart trainer, `train/fit.py` under `train_AR`/`train_GAR`)."""


def read(run):
    stages = [r["stage_s"][0] for r in run.records if r.get("stage_s")]
    if not stages:
        return None
    return 1e3 * sum(stages) / len(stages) / run.traffic["steps"]
