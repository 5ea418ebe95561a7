from .naming import get_expand_runname
from .registry import Registry
from .fingerprint import Hasher, Fingerprint

__all__ = ["get_expand_runname", "Registry", "Hasher", "Fingerprint"]
