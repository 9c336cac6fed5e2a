"""Plotting helpers: 1-D uncertainty bands + 2-D field triptychs.

A copy of `fidelityfusion_tpu/utils/plotting.py` (numpy in, matplotlib
imported inside each function; move tensors to the CPU first). Re-design
of the reference plotting conventions: the errorbar/fill-between 1-D plots
every model demo draws (`AR_autoRegression.py:187-191`), the
groundtruth/predict/difference heatmap triptych (`GAR.py:173-190`), and
the legacy `plot_container` shared-colorbar field grid
(`MFGP_ver2023May/utils/plot_field.py:12-150`). Matplotlib is imported
lazily so headless library use never pays for it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def plot_1d_posterior(
    x_test, mean, var, x_train=None, y_train=None, y_true=None, ax=None,
    title: Optional[str] = None,
):
    """Mean curve with +-1 std fill (the standard demo plot)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    x = np.asarray(x_test).ravel()
    m = np.asarray(mean).ravel()
    s = np.sqrt(np.maximum(np.asarray(var).ravel(), 0.0))
    order = np.argsort(x)
    ax.plot(x[order], m[order], "r-.", label="prediction")
    ax.fill_between(x[order], (m - s)[order], (m + s)[order], alpha=0.2)
    if y_true is not None:
        ax.plot(x[order], np.asarray(y_true).ravel()[order], "k-", label="truth")
    if x_train is not None and y_train is not None:
        ax.plot(np.asarray(x_train).ravel(), np.asarray(y_train).ravel(), "b+",
                label="train")
    if title:
        ax.set_title(title)
    ax.legend()
    return ax


def plot_field_triptych(truth, predict, fig=None, titles=("Groundtruth", "Predict", "Difference")):
    """Heatmap triptych with shared color scale (`GAR.py:173-190`)."""
    import matplotlib.pyplot as plt

    truth = np.asarray(truth)
    predict = np.asarray(predict)
    if fig is None:
        fig, axs = plt.subplots(1, 3, figsize=(15, 5))
    else:
        axs = fig.subplots(1, 3)
    vmin, vmax = truth.min(), truth.max()
    im = axs[0].imshow(truth, cmap="hot", interpolation="nearest", vmin=vmin, vmax=vmax)
    axs[1].imshow(predict, cmap="hot", interpolation="nearest", vmin=vmin, vmax=vmax)
    axs[2].imshow(np.abs(truth - predict), cmap="hot", interpolation="nearest",
                  vmin=vmin, vmax=vmax)
    for ax, t in zip(axs, titles):
        ax.set_title(t)
    cbar_ax = fig.add_axes([0.95, 0.2, 0.03, 0.6])
    fig.colorbar(im, cax=cbar_ax)
    return fig


def plot_field_grid(fields: Sequence, ncols: int = 4, clip_quantile: float = 0.0):
    """Shared-colorbar grid of 2-D fields with optional outlier clipping
    (legacy `plot_container` semantics, `plot_field.py:12-150`)."""
    import matplotlib.pyplot as plt

    fields = [np.asarray(f) for f in fields]
    flat = np.concatenate([f.ravel() for f in fields])
    if clip_quantile > 0:
        vmin = np.quantile(flat, clip_quantile)
        vmax = np.quantile(flat, 1 - clip_quantile)
    else:
        vmin, vmax = flat.min(), flat.max()
    n = len(fields)
    nrows = (n + ncols - 1) // ncols
    fig, axs = plt.subplots(nrows, ncols, figsize=(4 * ncols, 4 * nrows), squeeze=False)
    im = None
    for i, f in enumerate(fields):
        ax = axs[i // ncols][i % ncols]
        im = ax.imshow(f, cmap="hot", vmin=vmin, vmax=vmax)
    for j in range(len(fields), nrows * ncols):
        axs[j // ncols][j % ncols].axis("off")
    fig.colorbar(im, ax=[a for row in axs for a in row], shrink=0.7)
    return fig


def plot_bo_curve(records: dict, ax=None, label: Optional[str] = None):
    """Cost-vs-incumbent curve (`MF_BO_discrete.py:148-150` records)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    ax.plot(records["cost"], records["incumbents"], marker="o", label=label)
    ax.set_xlabel("cumulative cost")
    ax.set_ylabel("incumbent")
    if label:
        ax.legend()
    return ax
