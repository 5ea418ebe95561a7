"""Checkpoint I/O for the trainable tree.

Counterpart of ``mimic_tpu/train/checkpoints.py``: ``<run_dir>/epoch-N/``
holds ``encoder.msgpack``, the trainable tree as ``flax.serialization.to_bytes``
writes it, and ``<run_dir>/config.json`` the archived train config.  A file
written by either package loads in the other.

Neither ``flax`` nor ``msgpack`` is needed: this module writes and reads the
small msgpack subset that ``to_bytes`` of a tree of arrays produces — maps
with str keys in the tree's order and flax's ndarray extension
(ext type 1) whose payload is the msgpack array ``[shape, dtype name, raw
C-order bytes]``.  ``save_trainable`` writes keys sorted, as the JAX package's
``jax.tree.map`` before ``to_bytes`` leaves them.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..bridge import to_numpy, to_torch
from ..device import DeviceLike

ENCODER_FILE = "encoder.msgpack"
CONFIG_FILE = "config.json"
_NDARRAY_EXT = 1  # flax.serialization._MsgpackExtType.ndarray

# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------


def _pack_uint(n: int) -> bytes:
    if n < 0:
        raise ValueError("negative integers are not part of the checkpoint format")
    if n < 0x80:
        return bytes([n])
    for tag, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                            (0xCF, ">Q", 1 << 64)):
        if n < limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} too large")


def _pack_len(n: int, fix_tag: int, fix_max: int, tags: Tuple[int, ...]) -> bytes:
    """Header of a str / bin / array / map of length n (tags: 8-, 16-, 32-bit)."""
    if fix_tag is not None and n <= fix_max:
        return bytes([fix_tag | n])
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large")


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _pack_len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _pack_bin(b: bytes) -> bytes:
    return _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6)) + b


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        return bytes([fixed[len(data)], code]) + data
    return _pack_len(len(data), None, 0, (0xC7, 0xC8, 0xC9)) + bytes([code]) + data


def _pack_ndarray(a: np.ndarray) -> bytes:
    shape = _pack_len(a.ndim, 0x90, 15, (None, 0xDC, 0xDD)) + b"".join(
        _pack_uint(int(d)) for d in a.shape
    )
    name = "bfloat16" if a.dtype.names == ("bfloat16",) else a.dtype.name
    payload = _pack_len(3, 0x90, 15, (None, 0xDC, 0xDD)) + shape + _pack_str(name) + \
        _pack_bin(np.ascontiguousarray(a).tobytes("C"))
    return _pack_ext(_NDARRAY_EXT, payload)


def _pack_tree(node: Any) -> bytes:
    if isinstance(node, dict):
        items = list(node.items())
        return _pack_len(len(items), 0x80, 15, (None, 0xDE, 0xDF)) + b"".join(
            _pack_str(str(k)) + _pack_tree(v) for k, v in items
        )
    if isinstance(node, np.ndarray):
        return _pack_ndarray(node)
    raise TypeError(f"cannot serialize {type(node).__name__} in a checkpoint tree")


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated checkpoint")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if 0x80 <= tag <= 0x8F:
            return self._map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self._array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self.take(tag & 0x1F).decode("utf-8")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
        if tag in ints:
            return self.uint(ints[tag])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if tag in strs:
            return self.take(self.uint(strs[tag])).decode("utf-8")
        bins = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if tag in bins:
            return self.take(self.uint(bins[tag]))
        if tag in (0xDC, 0xDD):
            return self._array(self.uint(">H" if tag == 0xDC else ">I"))
        if tag in (0xDE, 0xDF):
            return self._map(self.uint(">H" if tag == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if tag in fixext or tag in exts:
            n = fixext[tag] if tag in fixext else self.uint(exts[tag])
            code = self.take(1)[0]
            return self._ext(code, self.take(n))
        raise ValueError(f"msgpack tag 0x{tag:02x} is not part of the checkpoint format")

    def _map(self, n: int) -> Dict[str, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    @staticmethod
    def _ext(code: int, payload: bytes) -> np.ndarray:
        if code != _NDARRAY_EXT:
            raise ValueError(f"msgpack ext type {code} is not part of the checkpoint format")
        shape, dtype, raw = _Reader(payload).read()
        if dtype == "bfloat16":  # no numpy bfloat16 here: keep the bits, typed by name
            arr = np.frombuffer(raw, np.uint16).reshape(shape).copy()
            return arr.view(np.dtype([("bfloat16", np.uint16)]))
        return np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()


def tree_to_bytes(tree: Dict[str, Any]) -> bytes:
    """Nested dict of numpy arrays → the bytes of ``flax.serialization.to_bytes``."""
    return _pack_tree(tree)


def tree_from_bytes(data: bytes) -> Dict[str, Any]:
    """Inverse of ``tree_to_bytes`` (also reads files written by flax)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data) or not isinstance(tree, dict):
        raise ValueError("not a checkpoint tree")
    return tree


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------


def _bf16_bits_to_torch(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _bf16_bits_to_torch(v, device) for k, v in tree.items()}
    if tree.dtype.names == ("bfloat16",):
        return torch.from_numpy(tree.view(np.int16)).view(torch.bfloat16).to(device)
    return to_torch(tree, device)


def numpy_tree(tree: Any, sort_keys: bool = True) -> Any:
    """torch tree → numpy tree for ``tree_to_bytes`` (bf16 leaves as their bits,
    typed by name); keys sorted, as ``jax.tree.map`` leaves a dict, or in the
    tree's own order."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort_keys else tree
        return {k: numpy_tree(tree[k], sort_keys) for k in keys}
    if tree.dtype == torch.bfloat16:
        bits = tree.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16)
        return bits.view(np.dtype([("bfloat16", np.uint16)]))
    return to_numpy(tree)


def save_trainable(ckpt_dir: str, trainable: Dict[str, Any]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, ENCODER_FILE), "wb") as f:
        f.write(tree_to_bytes(numpy_tree(trainable)))


def load_trainable(
    ckpt_dir: str, template: Optional[Dict[str, Any]] = None, device: DeviceLike = "cpu"
) -> Dict[str, Any]:
    """The saved tree as torch tensors on ``device``; with a ``template``, its
    keys and leaf shapes must match (as ``flax.serialization.from_bytes``
    requires)."""
    with open(os.path.join(ckpt_dir, ENCODER_FILE), "rb") as f:
        tree = tree_from_bytes(f.read())
    out = _bf16_bits_to_torch(tree, torch.device(device))
    if template is not None:
        _check_like(out, template, ())
    return out


def _check_like(got: Any, want: Any, path: Tuple[str, ...]) -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"checkpoint keys at {path}: {sorted(got)} != {sorted(want)}")
        for k in want:
            _check_like(got[k], want[k], path + (k,))
    elif tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"checkpoint leaf {path}: shape {tuple(got.shape)} != {tuple(want.shape)}")


def save_run_config(run_dir: str, cfg_dict: Dict[str, Any]) -> None:
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, CONFIG_FILE), "w") as f:
        json.dump(cfg_dict, f, indent=4, default=str)


def existing_ckpt_epochs(run_dir: str) -> List[int]:
    if not os.path.isdir(run_dir):
        return []
    out = []
    for d in os.listdir(run_dir):
        if d.startswith("epoch-"):
            try:
                out.append(int(d.split("-")[-1]))
            except ValueError:
                pass
    return sorted(out)


def all_checkpoints_exist(run_dir: str, max_epochs: int, save_when) -> bool:
    """Reference resume-skip: every epoch that save_when wants is already saved."""
    have = set(existing_ckpt_epochs(run_dir))
    return all(not save_when(e) or e in have for e in range(max_epochs))
