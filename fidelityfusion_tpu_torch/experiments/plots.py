"""Sweep-result aggregation + figures.

A copy of `fidelityfusion_tpu/experiments/plots.py` (numpy; matplotlib
imported inside each plotting function). Re-design of the reference's per-
experiment plotting scripts (`Experiments/*/pic_*.py`,
`MFBO_continuous/graphs.py`, ~480 LoC of copy-pasted CSV->matplotlib
code): one generic aggregator over the sweep harness's CSV layout
(`<outdir>/<dataset>/<method>_seed_<s>.csv`) producing the reference's
figure types — metric vs n_high with seed error bars, and cost-vs-
incumbent BO curves.
"""

from __future__ import annotations

import csv
import glob
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


def load_sweep_results(outdir: str, dataset: str) -> Dict[str, Dict[int, List[dict]]]:
    """{method: {seed: [row dicts sorted by n_high]}}."""
    out: Dict[str, Dict[int, List[dict]]] = defaultdict(dict)
    for path in glob.glob(os.path.join(outdir, dataset, "*_seed_*.csv")):
        m = re.match(r"(.+)_seed_(\d+)\.csv$", os.path.basename(path))
        if not m:
            continue
        method, seed = m.group(1), int(m.group(2))
        with open(path) as f:
            rows = [
                {k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)
            ]
        for r in rows:
            # reference CSV column is train_sample_num (`exp_non_aligned
            # .py:53`); older files may carry n_high
            r.setdefault("n_high", r.get("train_sample_num"))
        out[method][seed] = sorted(rows, key=lambda r: r["n_high"])
    return dict(out)


def aggregate_metric(
    results: Dict[str, Dict[int, List[dict]]], metric: str = "rmse"
):
    """{method: (n_high array, mean array, std array)} over seeds."""
    agg = {}
    for method, seeds in results.items():
        by_n = defaultdict(list)
        for rows in seeds.values():
            for r in rows:
                by_n[r["n_high"]].append(r[metric])
        ns = np.array(sorted(by_n))
        mean = np.array([np.mean(by_n[n]) for n in ns])
        std = np.array([np.std(by_n[n]) for n in ns])
        agg[method] = (ns, mean, std)
    return agg


def plot_metric_vs_nhigh(
    outdir: str,
    dataset: str,
    metric: str = "rmse",
    save_to: Optional[str] = None,
    log_y: bool = True,
):
    """The GAR-paper-style figure: metric vs hi-fid count, one line per
    method, seed std as error band (`Experiments/Readme.md:5-17`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    agg = aggregate_metric(load_sweep_results(outdir, dataset), metric)
    fig, ax = plt.subplots(figsize=(6, 4))
    for method, (ns, mean, std) in sorted(agg.items()):
        ax.plot(ns, mean, marker="o", label=method)
        ax.fill_between(ns, mean - std, mean + std, alpha=0.2)
    ax.set_xlabel("high-fidelity training samples")
    ax.set_ylabel(metric)
    if log_y and metric in ("rmse", "nrmse"):
        ax.set_yscale("log")
    ax.set_title(dataset)
    ax.legend()
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=150)
    return fig


def plot_bo_records(
    records_by_method: Dict[str, Sequence[dict]],
    save_to: Optional[str] = None,
):
    """Cost-vs-incumbent mean curves with seed bands
    (`MFBO_continuous/graphs.py` style)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for method, records in sorted(records_by_method.items()):
        curves = [np.asarray(r["incumbents"]) for r in records]
        n = min(len(c) for c in curves)
        stack = np.stack([c[:n] for c in curves])
        cost = np.asarray(records[0]["cost"])[:n]
        mean = stack.mean(axis=0)
        std = stack.std(axis=0)
        ax.plot(cost, mean, marker="o", label=method)
        ax.fill_between(cost, mean - std, mean + std, alpha=0.2)
    ax.set_xlabel("cumulative cost")
    ax.set_ylabel("incumbent")
    ax.legend()
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=150)
    return fig


def plot_headtohead_curves(
    outdir: str,
    save_to: Optional[str] = None,
):
    """Cost-vs-incumbent curves from `scripts/mfbo_headtohead.py` CSVs
    (columns iteration,cost,incumbent; one file per framework/acq/seed):
    mean over seeds, solid = ours, dashed = reference."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups: Dict[tuple, list] = defaultdict(list)
    for path in glob.glob(os.path.join(outdir, "*_seed_*.csv")):
        m = re.match(r"(.+?)_(.+)_seed_(\d+)\.csv$", os.path.basename(path))
        if not m:
            continue
        fw, acq = m.group(1), m.group(2)
        with open(path) as f:
            rows = [(float(r["cost"]), float(r["incumbent"]))
                    for r in csv.DictReader(f)]
        groups[(fw, acq)].append(rows)

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for (fw, acq), runs in sorted(groups.items()):
        n = min(len(r) for r in runs)
        cost = np.mean([[c for c, _ in r[:n]] for r in runs], axis=0)
        inc = np.stack([[v for _, v in r[:n]] for r in runs])
        style = "--" if fw == "reference" else "-"
        ax.plot(cost, inc.mean(0), style, marker=".", label=f"{fw} {acq}")
        ax.fill_between(cost, inc.mean(0) - inc.std(0),
                        inc.mean(0) + inc.std(0), alpha=0.12)
    ax.set_xlabel("cumulative cost")
    ax.set_ylabel("incumbent (max observed top-fidelity y)")
    ax.legend(fontsize=8)
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=150)
    return fig
