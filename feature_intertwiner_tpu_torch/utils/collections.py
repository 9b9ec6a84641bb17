"""Attribute-access dict with an immutability latch.

A copy of ``feature_intertwiner_tpu/utils/collections.py`` (the port imports
nothing of the JAX package): keys readable/writable as attributes, and a
recursive ``freeze()`` that makes the tree read-only.
"""

from __future__ import annotations

from typing import Any


class AttrDict(dict):
    """dict whose items are also attributes; supports recursive freezing."""

    _FROZEN_KEY = "__attrdict_frozen__"

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        super().__setattr__(AttrDict._FROZEN_KEY, False)

    @property
    def frozen(self) -> bool:
        return super().__getattribute__(AttrDict._FROZEN_KEY)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:  # keep normal AttributeError semantics
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        if self.frozen:
            raise AttributeError(
                f"AttrDict is frozen; cannot set {name!r}. Call freeze(False) first."
            )
        self[name] = value

    def __delattr__(self, name: str) -> None:
        if self.frozen:
            raise AttributeError(
                f"AttrDict is frozen; cannot delete {name!r}. Call freeze(False) first."
            )
        try:
            del self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def freeze(self, frozen: bool = True) -> "AttrDict":
        """Recursively (un)freeze this dict and every AttrDict value under it."""
        super().__setattr__(AttrDict._FROZEN_KEY, frozen)
        for value in self.values():
            if isinstance(value, AttrDict):
                value.freeze(frozen)
        return self

    def clone(self) -> "AttrDict":
        """Deep copy (AttrDict children copied recursively; leaves shared)."""
        out = AttrDict()
        for key, value in self.items():
            out[key] = value.clone() if isinstance(value, AttrDict) else value
        return out
