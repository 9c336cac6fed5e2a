"""The top stage's wall milliseconds per Adam step, over the window's
fits (AR: the 256-row fused path)."""


def read(run):
    stages = [r["stage_s"][-1] for r in run.records if r.get("stage_s")]
    if not stages:
        return None
    return 1e3 * sum(stages) / len(stages) / run.traffic["steps"]
