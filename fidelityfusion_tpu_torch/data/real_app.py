"""Real-application BO objectives: neural-network training accuracy vs
hyperparameters, with training epochs as the fidelity.

Port of `fidelityfusion_tpu/data/real_app.py` (re-design of
`Data_simulation/Real_Application/{cnn_cifar10,mln_mnist}.py:47-117`,
which train a CNN on CIFAR-100 / an MLP on MNIST and return validation
accuracy, fidelity = epochs).  Without dataset downloads:

* `DigitsMLPObjective` / `DigitsCNNObjective` train on scikit-learn's
  bundled handwritten digits (1797 8x8 images, 10 classes, no network);
  without scikit-learn they raise ImportError;
* `MLPTrainingObjective` / `CNNTrainingObjective` train on seeded
  synthetic tasks (two moons; a blob in one of four image quadrants).

Protocol as the reference objectives: ``get_data(x, s)`` -> ``(n, 1)``
numpy validation accuracies, ``x`` the hyperparameters and ``s`` the
1-based fidelity (``10 * s`` full-batch epochs), plus ``initiate_data``,
``search_range`` and ``cost``.

The networks are `nn.Module`s trained full-batch on ``device`` (default
``"cuda"``).  The optimizers follow optax's rules exactly: Adam with
bias-corrected moments and eps outside the square root, and RMSprop
(decay 0.9, eps INSIDE the square root, no bias correction), not
`torch.optim.RMSprop`'s.  The CNNs compute in NCHW/OIHW and flatten their
features in the JAX package's (h, w, c) order, so the dense heads keep its
layout (`convert.net_params_from_numpy` maps HWIO kernels to OIHW).

Every random draw (the synthetic datasets, initial weights, dropout keep
masks) comes from a CPU ``torch.Generator`` seeded from ``seed``, so the
CPU and the card train the same network; each also accepts given arrays
(``data=``, ``params=``, ``keep_masks=``: the JAX package's draws in the
tests).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fidelityfusion_tpu_torch.data.cost import LinearCost
from fidelityfusion_tpu_torch.utils.device import resolve_device

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults
RMS_DECAY, RMS_EPS = 0.9, 1e-8        # optax.rmsprop's defaults


def _make_dataset(generator: torch.Generator, n: int = 512, noise: float = 0.2):
    """Two-moons-style binary classification, drawn from ``generator``."""
    t = torch.rand((n,), generator=generator) * math.pi
    upper = torch.rand((n,), generator=generator) < 0.5
    x0 = torch.where(upper, torch.cos(t), 1.0 - torch.cos(t))
    x1 = torch.where(upper, torch.sin(t), 0.5 - torch.sin(t))
    X = torch.stack([x0, x1], dim=1)
    X = X + noise * torch.randn(X.shape, generator=generator)
    return X, upper.long()


def _make_image_dataset(generator: torch.Generator, n: int = 256, size: int = 8,
                        n_classes: int = 4):
    """Synthetic image classification: a bright blob in one of four
    quadrants (+noise); the class is the quadrant.  NHWC images."""
    y = torch.randint(0, n_classes, (n,), generator=generator)
    cy = torch.where(y // 2 == 0, size // 4, 3 * size // 4).float()
    cx = torch.where(y % 2 == 0, size // 4, 3 * size // 4).float()
    jit_pos = torch.randn((n, 2), generator=generator) * 0.5
    rows = torch.arange(size, dtype=torch.float32)
    d2 = ((rows[None, :, None] - (cy + jit_pos[:, 0])[:, None, None]) ** 2
          + (rows[None, None, :] - (cx + jit_pos[:, 1])[:, None, None]) ** 2)
    X = torch.exp(-0.5 * d2 / 2.0) + 0.3 * torch.randn((n, size, size), generator=generator)
    return X[..., None], y


class _Net(nn.Module):
    """Parameters by the JAX package's names (conv kernels OIHW), the
    forward given by a subclass; ``keep`` is a dropout keep mask of the
    dropped layer's shape, ``rate`` its dropout rate."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.p = nn.ParameterDict({k: nn.Parameter(v.detach().clone()) for k, v in params.items()})

    @staticmethod
    def _drop(h, keep, rate):
        return h if keep is None else torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


class TanhMLP(_Net):
    """2 -> width (tanh) -> 2 (`MLPTrainingObjective`)."""

    def forward(self, X, keep=None, rate=0.0):
        p = self.p
        return torch.tanh(X @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


class ReluMLP(_Net):
    """64 -> width (ReLU, dropout) -> 10 (`DigitsMLPObjective`)."""

    def forward(self, X, keep=None, rate=0.0):
        p = self.p
        h = self._drop(F.relu(X @ p["w1"] + p["b1"]), keep, rate)
        return h @ p["w2"] + p["b2"]


def _flatten_hwc(h):
    """(n, c, h, w) -> (n, h*w*c) in the JAX package's NHWC order."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class QuadrantCNN(_Net):
    """3x3 conv ("SAME", no bias) -> ReLU -> 2x2 max pool -> dense
    (`CNNTrainingObjective`); NHWC images in."""

    def forward(self, X, keep=None, rate=0.0):
        h = F.relu(F.conv2d(X.permute(0, 3, 1, 2), self.p["conv"], padding=1))
        return _flatten_hwc(F.max_pool2d(h, 2)) @ self.p["w"] + self.p["b"]


class DigitsCNN(_Net):
    """Two 3x3 conv blocks (8 -> 16 channels, ReLU, 2x2 mean pool after the
    first) -> dropout -> dense 10 (`DigitsCNNObjective`); flat 8x8 rows in."""

    def forward(self, X, keep=None, rate=0.0):
        p = self.p
        h = F.relu(F.conv2d(X.reshape(-1, 1, 8, 8), p["k1"], p["b1"], padding=1))
        h = F.avg_pool2d(h, 2)
        h = F.relu(F.conv2d(h, p["k2"], p["b2"], padding=1))
        return self._drop(_flatten_hwc(h), keep, rate) @ p["w"] + p["b"]


def _bias_correction(decay: float, t: int) -> float:
    """``1 - decay**t`` in float32, as optax computes it (in float64 it
    differs by up to 1.3e-5 relative at t = 1 for decay 0.999)."""
    one = torch.ones((), dtype=torch.float32)
    return float(1 - torch.pow(one * decay, t))


def _adam(params, lr):
    """optax.adam(lr) as a step function over ``params`` (their .grad)."""
    state = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    t = [0]

    @torch.no_grad()
    def step():
        t[0] += 1
        c1, c2 = _bias_correction(B1, t[0]), _bias_correction(B2, t[0])
        for p, (mu, nu) in zip(params, state):
            g = p.grad
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).add_(g * g, alpha=1 - B2)
            p.sub_(lr * ((mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)))
    return step


def _rmsprop(params, lr):
    """optax.rmsprop(lr) as a step function: ``nu = 0.9 nu + 0.1 g^2``,
    ``p -= lr g / sqrt(nu + eps)`` (eps inside the square root, no bias
    correction, nu starting at 0)."""
    state = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step():
        for p, nu in zip(params, state):
            g = p.grad
            nu.mul_(RMS_DECAY).add_(g * g, alpha=1 - RMS_DECAY)
            p.sub_(lr * (torch.rsqrt(nu + RMS_EPS) * g))
    return step


def _fit(net: _Net, optimizer, lr, X, y, Xv, epochs: int, keep_masks=None, rate=0.0):
    """``epochs`` full-batch steps of mean cross-entropy; returns the
    validation logits of the trained net (no dropout)."""
    params = list(net.parameters())
    step = optimizer(params, lr)
    for e in range(epochs):
        keep = None if keep_masks is None else keep_masks[e]
        loss = F.cross_entropy(net(X, keep, rate), y)
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        step()
    with torch.no_grad():
        return net(Xv)


def _as_tensor(a, device, dtype):
    return torch.as_tensor(a if torch.is_tensor(a) else np.array(a), dtype=dtype, device=device)


class _Objective:
    """Shared protocol: data on ``device``, accuracy of given logits,
    ``get_data`` over rows, ``initiate_data`` by the JAX package's
    sampling."""

    search_range = [[-4.0, -1.0], [0.0, 1.0], [0, 1]]

    def __init__(self, total_fidelity_num: int, device):
        self.device = resolve_device(device)
        self.total_fidelity_num = total_fidelity_num
        self.x_dim = 2
        self.cost = LinearCost(rate=10.0)

    def _set_data(self, X_train, y_train, X_val, y_val):
        f32, i64, dev = torch.float32, torch.long, self.device
        self.X_train, self.X_val = _as_tensor(X_train, dev, f32), _as_tensor(X_val, dev, f32)
        self.y_train, self.y_val = _as_tensor(y_train, dev, i64), _as_tensor(y_val, dev, i64)

    def accuracy(self, logits) -> float:
        return float((logits.argmax(dim=1) == self.y_val).float().mean())

    def _train_one(self, a: float, b: float, epochs: int, seed: int = 0, **given) -> float:
        """Validation accuracy after ``epochs`` epochs at hyperparameters
        (a, b) (the order of ``x``'s columns)."""
        return self.accuracy(self._val_logits(a, b, epochs, seed, **given))

    def get_data(self, x: np.ndarray, s: int) -> np.ndarray:
        """x: (n, 2) raw hyperparameters; s: 1-based fidelity -> 10*s
        training epochs.  Returns validation accuracy (n, 1)."""
        x = np.atleast_2d(np.asarray(x, float))
        out = np.array([self._train_one(row[0], row[1], epochs=10 * int(s)) for row in x])
        return out.reshape(-1, 1)

    def _sample(self, rng, n):
        lr = rng.random((n, 1)) * 3 - 4  # log10 lr in [-4, -1]
        w = rng.random((n, 1))
        return np.concatenate([lr, w], axis=1)

    def initiate_data(self, index: Dict[int, int], seed: int):
        rng = np.random.default_rng(seed)
        x_low = self._sample(rng, index[1])
        x_high = np.concatenate([x_low[: index[2] - 2], self._sample(rng, 2)], axis=0)
        return [x_low, x_high], [self.get_data(x_low, 1), self.get_data(x_high, 2)]

    Initiate_data = initiate_data


class MLPTrainingObjective(_Objective):
    """Hyperparameter-BO objective: validation accuracy of a 2-layer tanh
    MLP after ``10*s`` epochs of full-batch Adam (`mln_mnist.py:47-90`
    analog).  x = (log10 lr in [-4, -1], hidden width fraction in [0, 1]).
    ``data``: ``(X_train, y_train, X_val, y_val)`` in place of the seeded
    two-moons draws (512 train, 256 validation rows)."""

    def __init__(self, total_fidelity_num: int = 2, seed: int = 0, max_width: int = 64,
                 data=None, device="cuda"):
        super().__init__(total_fidelity_num, device)
        self.max_width = max_width
        if data is None:
            g = torch.Generator().manual_seed(seed)
            data = (*_make_dataset(g), *_make_dataset(g, n=256))
        self._set_data(*data)

    def width(self, width_frac: float) -> int:
        return max(4, int(round(width_frac * self.max_width)))

    def init_params(self, width: int, seed: int = 0) -> Dict[str, torch.Tensor]:
        g = torch.Generator().manual_seed(seed)
        return {"w1": torch.randn((2, width), generator=g) * 0.5, "b1": torch.zeros(width),
                "w2": torch.randn((width, 2), generator=g) * 0.5, "b2": torch.zeros(2)}

    def _val_logits(self, log10_lr, width_frac, epochs, seed=0, params=None):
        params = params or self.init_params(self.width(width_frac), seed)
        net = TanhMLP(params).to(self.device)
        return _fit(net, _adam, 10.0 ** float(log10_lr), self.X_train, self.y_train,
                    self.X_val, epochs)


class CNNTrainingObjective(_Objective):
    """Hyperparameter-BO objective: validation accuracy of a small CNN
    after ``10*s`` epochs of full-batch Adam (`cnn_cifar10.py:60-117`
    analog) on a seeded synthetic quadrant-classification task (256 train,
    128 validation NHWC images).  x = (log10 lr, channel-width fraction)."""

    def __init__(self, total_fidelity_num: int = 2, seed: int = 0, max_channels: int = 16,
                 image_size: int = 8, data=None, device="cuda"):
        super().__init__(total_fidelity_num, device)
        self.max_channels = max_channels
        self.image_size = image_size
        if data is None:
            g = torch.Generator().manual_seed(seed)
            data = (*_make_image_dataset(g, n=256, size=image_size),
                    *_make_image_dataset(g, n=128, size=image_size))
        self._set_data(*data)

    def channels(self, width_frac: float) -> int:
        return max(2, int(round(width_frac * self.max_channels)))

    def init_params(self, ch: int, seed: int = 0) -> Dict[str, torch.Tensor]:
        g = torch.Generator().manual_seed(seed)
        feat = (self.image_size // 2) ** 2 * ch
        return {"conv": torch.randn((ch, 1, 3, 3), generator=g) * 0.3,
                "w": torch.randn((feat, 4), generator=g) * 0.1, "b": torch.zeros(4)}

    def _val_logits(self, log10_lr, width_frac, epochs, seed=0, params=None):
        params = params or self.init_params(self.channels(width_frac), seed)
        net = QuadrantCNN(params).to(self.device)
        return _fit(net, _adam, 10.0 ** float(log10_lr), self.X_train, self.y_train,
                    self.X_val, epochs)


class DigitsMLPObjective(_Objective):
    """Hyperparameter-BO objective on real data: validation accuracy of a
    2-layer ReLU MLP with dropout on scikit-learn's bundled digits after
    ``10*s`` epochs of full-batch Adam (`mln_mnist.py:47-90`: MLP with
    dropout, test accuracy, fidelity = epochs).  x = (dropout rate in
    [0, 0.8], log10 lr in [-4, -1]).  Deterministic: each epoch's dropout
    mask is a fixed draw (the reference's seed_everything policy,
    `mln_mnist.py:18-20`).  Raises ImportError without scikit-learn."""

    search_range = [[0.0, 0.8], [-4.0, -1.0], [0, 1]]

    def __init__(self, total_fidelity_num: int = 2, seed: int = 0, width: int = 64,
                 n_train: int = 1200, device="cuda"):
        from sklearn.datasets import load_digits

        super().__init__(total_fidelity_num, device)
        self.width = width
        d = load_digits()
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(d.data))
        X = (d.data[perm] / 16.0).astype(np.float32)
        y = d.target[perm].astype(np.int32)
        self._set_data(X[:n_train], y[:n_train], X[n_train:], y[n_train:])

    NET = ReluMLP
    OPTIMIZER = staticmethod(_adam)
    SEED_OFFSET = 0

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        g = torch.Generator().manual_seed(seed)
        w = self.width
        return {"w1": torch.randn((64, w), generator=g) * (1.0 / 8.0), "b1": torch.zeros(w),
                "w2": torch.randn((w, 10), generator=g) * (1.0 / math.sqrt(w)),
                "b2": torch.zeros(10)}

    def dropped_shape(self):
        """The shape of one epoch's dropout keep mask."""
        return (len(self.X_train), self.width)

    def keep_masks(self, rate: float, epochs: int, seed: int = 0) -> torch.Tensor:
        """(epochs, *dropped_shape) keep masks, each element kept with
        probability 1 - rate, from a generator of their own."""
        g = torch.Generator().manual_seed(seed + self.SEED_OFFSET + 1)
        return torch.rand((epochs, *self.dropped_shape()), generator=g) < 1.0 - rate

    def _val_logits(self, dropout, log10_lr, epochs, seed=0, params=None, keep_masks=None):
        rate = float(np.clip(dropout, 0.0, 0.95))
        params = params or self.init_params(seed + self.SEED_OFFSET)
        masks = None
        if rate > 0:
            masks = self.keep_masks(rate, epochs, seed) if keep_masks is None else keep_masks
            masks = _as_tensor(masks, self.device, torch.bool)
        net = self.NET(params).to(self.device)
        return _fit(net, self.OPTIMIZER, 10.0 ** float(log10_lr), self.X_train, self.y_train,
                    self.X_val, epochs, masks, rate)

    def _sample(self, rng, n):
        dr = rng.random((n, 1)) * 0.8
        lr = rng.random((n, 1)) * 3 - 4
        return np.concatenate([dr, lr], axis=1)


class DigitsCNNObjective(DigitsMLPObjective):
    """Hyperparameter-BO objective on real data: validation accuracy of a
    small conv net on scikit-learn's bundled digits after ``10*s`` epochs
    of full-batch RMSprop (`cnn_cifar10.py:40-117`: conv blocks ->
    dropout -> dense head, RMSprop, fidelity = epochs).  Two 3x3 conv
    blocks (8 -> 16 channels, ReLU, 2x2 mean pool after the first) ->
    dropout -> dense 10.  x = (dropout in [0, 0.8], log10 lr in [-4, -1])."""

    NET = DigitsCNN
    OPTIMIZER = staticmethod(_rmsprop)
    SEED_OFFSET = 7
    C1, C2 = 8, 16

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        g = torch.Generator().manual_seed(seed)
        c1, c2 = self.C1, self.C2
        return {"k1": torch.randn((c1, 1, 3, 3), generator=g) * 0.3, "b1": torch.zeros(c1),
                "k2": torch.randn((c2, c1, 3, 3), generator=g) * 0.15, "b2": torch.zeros(c2),
                "w": torch.randn((4 * 4 * c2, 10), generator=g) * (1.0 / math.sqrt(4 * 4 * c2)),
                "b": torch.zeros(10)}

    def dropped_shape(self):
        return (len(self.X_train), 4 * 4 * self.C2)
