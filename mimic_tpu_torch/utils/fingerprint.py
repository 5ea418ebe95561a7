"""Data-integrity hashing, parity with reference ``testbed/utils/fingerprint.py``.

``Hasher`` hashes arbitrary picklable objects; ``Fingerprint`` stores keyed hashes and
validates later recomputations — a reproducibility aid for encoded samples.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

import dill

try:
    import xxhash

    def _hash_bytes(data: bytes) -> str:
        return xxhash.xxh64(data).hexdigest()

except ImportError:  # pragma: no cover

    def _hash_bytes(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()


class Hasher:
    """Hash arbitrary objects via dill serialization."""

    @staticmethod
    def hash_bytes(data: bytes) -> str:
        return _hash_bytes(data)

    @staticmethod
    def hash(obj: Any) -> str:
        return _hash_bytes(dill.dumps(obj, recurse=False))


class Fingerprint:
    """Store and validate keyed content hashes."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._store: Dict[str, str] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self._store = json.load(f)

    def update(self, key: str, obj: Any) -> str:
        digest = Hasher.hash(obj)
        self._store[key] = digest
        return digest

    def validate(self, key: str, obj: Any) -> bool:
        if key not in self._store:
            raise KeyError(f"No fingerprint recorded for key {key!r}")
        return self._store[key] == Hasher.hash(obj)

    def save(self, path: Optional[str] = None) -> None:
        target = path or self.path
        if target is None:
            raise ValueError("No path to save fingerprint store")
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
        with open(target, "w") as f:
            json.dump(self._store, f, indent=2, sort_keys=True)

    def __contains__(self, key: str) -> bool:
        return key in self._store
