"""Generic named registry with optional signature validation.

Replaces the reference's decorator registries (``testbed/data/common.py:11-82``).
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Generic, Iterator, Optional, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str, expected_params: Optional[int] = None):
        self.kind = kind
        self.expected_params = expected_params
        self._items: Dict[str, T] = {}

    def register(self, name: str, *, exist_ok: bool = False) -> Callable[[T], T]:
        def decorator(fn: T) -> T:
            if name in self._items and not exist_ok:
                raise KeyError(f"{self.kind} {name!r} is already registered")
            if self.expected_params is not None and callable(fn):
                n = len(inspect.signature(fn).parameters)
                if n != self.expected_params:
                    raise TypeError(
                        f"{self.kind} {name!r} must take {self.expected_params} "
                        f"parameters, got {n}"
                    )
            self._items[name] = fn
            return fn

        return decorator

    def get(self, name: str) -> T:
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(
                f"No {self.kind} registered for {name!r} "
                f"(registered: {', '.join(sorted(self._items)) or 'none'})"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def names(self):
        return sorted(self._items)
