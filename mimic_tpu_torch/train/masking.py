"""Label-segment masking for the dual-pass training objective.

The reference locates query/answer segments by counting ``[PAD]`` separator tokens
inside the tokenized sequence at runtime (``src/shift_model.py:75-110``) and then
``masked_select``s hidden states — dynamic shapes everywhere.  Here the same masks
are computed on the **host** at collate time (numpy), and converted into fixed-width
``(indices, valid)`` gather pairs so the jitted loss works on static shapes: the
mask-weighted losses are numerically identical to the reference's gathered means.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def generate_label_mask(
    input_ids: np.ndarray,
    pad_token_id: int,
    num_separator: int,
    padding_side: str = "right",
    keep_bos: bool = False,
) -> np.ndarray:
    """Boolean mask of non-pad tokens strictly after the ``num_separator``-th pad.

    Parity with reference ``generate_label_mask`` (``src/shift_model.py:75-110``):
    with left padding, leading pads (before the first non-pad) are not counted as
    separators.  Raises if a row has fewer pads than ``num_separator``.
    """
    input_ids = np.asarray(input_ids)
    B, T = input_ids.shape
    pad_mask = input_ids == pad_token_id
    non_pad = ~pad_mask
    label_mask = np.zeros((B, T), bool)
    bos_position = non_pad.argmax(axis=1)
    for i in range(B):
        pad_positions = np.nonzero(pad_mask[i])[0]
        if padding_side == "left":
            pad_positions = pad_positions[pad_positions > bos_position[i]]
        if len(pad_positions) < num_separator:
            raise ValueError(
                f"Sequence {i} has fewer pad tokens ({len(pad_positions)}) than "
                f"num_separator ({num_separator})"
            )
        sep = pad_positions[num_separator - 1]
        label_mask[i, sep + 1 :] = True
    label_mask &= non_pad
    if keep_bos:
        label_mask[np.arange(B), bos_position] = True
    return label_mask


def mask_to_gather(
    mask: np.ndarray, width: int = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Bool mask [B,T] → (indices [B,M] int32, valid [B,M] bool), selected in
    sequence order; M = max count (or ``width``).  Invalid slots index position 0."""
    mask = np.asarray(mask, bool)
    B, T = mask.shape
    counts = mask.sum(axis=1)
    M = int(counts.max()) if width is None else width
    if (counts > M).any():
        raise ValueError(f"gather width {M} < max selected count {int(counts.max())}")
    M = max(M, 1)
    indices = np.zeros((B, M), np.int32)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        pos = np.nonzero(mask[b])[0]
        indices[b, : len(pos)] = pos
        valid[b, : len(pos)] = True
    return indices, valid


def paired_gather_width(*masks: np.ndarray) -> int:
    """Common fixed width for a set of masks that must be gathered pairwise."""
    return max(1, max(int(np.asarray(m).sum(axis=1).max()) for m in masks))
