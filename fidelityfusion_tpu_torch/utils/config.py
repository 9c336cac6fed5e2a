"""Config system: nested defaults with deep merging.

Port of `fidelityfusion_tpu/utils/config.py` (plain Python, copied so the
port imports nothing of the JAX package): `update_dict_with_default`
deep-merges an update over a model's ``default_config``, `Config` is a
read-only dot-access view, `make_config` both at once.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping


def update_dict_with_default(default: Mapping, update: Mapping) -> Dict:
    """Deep-merge ``update`` over ``default`` (neither is mutated)."""
    out = copy.deepcopy(dict(default))
    for k, v in update.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = update_dict_with_default(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Config:
    """Read-only dot/bracket access over a nested dict."""

    def __init__(self, data: Mapping):
        self._data = dict(data)

    def __getattr__(self, name: str) -> Any:
        try:
            v = self._data[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, Mapping) else v

    def __getitem__(self, name: str) -> Any:
        v = self._data[name]
        return Config(v) if isinstance(v, Mapping) else v

    def get(self, name: str, default=None):
        v = self._data.get(name, default)
        return Config(v) if isinstance(v, Mapping) else v

    def to_dict(self) -> Dict:
        return copy.deepcopy(self._data)

    def __repr__(self):
        return f"Config({self._data!r})"


def make_config(default: Mapping, update: Mapping = None) -> Config:
    return Config(update_dict_with_default(default, update or {}))
