"""Seeded inputs: VQAv2-style questions and answers of exact lengths, and
COCO-like images of fixed sizes.

Every seed gets the same sizes (text lengths, image shapes) in another order
with other contents, so that the work of a run does not depend on its seed.
With the byte-level tokenizer a text's length in tokens is its length in
bytes, so exact character counts fix the token counts.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .copied import WORDS, synthetic_image

OPENERS = ("What color is the", "How many", "Is there a", "What is the", "Where is the",
           "What kind of", "Is the", "Which")
# one word of each length, to land a text on its exact length
FILL = {1: "a", 2: "on", 3: "the", 4: "near", 5: "table", 6: "person", 7: "kitchen",
        8: "standing", 9: "buildings", 10: "background"}
ANSWERS = {1: ("2", "3", "1"), 2: ("no", "on"), 3: ("yes", "red", "dog", "cat"),
           4: ("blue", "bird", "snow"), 5: ("white", "green", "table"),
           6: ("tennis", "yellow", "orange"), 7: ("kitchen", "giraffe"), 8: ("baseball",)}


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, *stream])


def question(rng: np.random.Generator, n_chars: int) -> str:
    """A question of exactly ``n_chars`` characters (at least 14)."""
    text = str(rng.choice([o for o in OPENERS if len(o) <= n_chars - 4]))
    r = n_chars - len(text) - 1          # characters left before the "?"
    while r > 11:
        w = str(rng.choice([w for w in WORDS if len(w) <= r - 3]))
        text += " " + w
        r -= len(w) + 1
    if r >= 2:
        text += " " + FILL[r - 1]
    elif r == 1:
        text += "s"
    return text + "?"


def answer(rng: np.random.Generator, n_chars: int) -> str:
    return str(rng.choice(ANSWERS[n_chars]))


def image(seed: int, index: int, hw: Tuple[int, int]) -> np.ndarray:
    """A seeded uint8 RGB image of size ``hw`` (the copied ``synthetic_image``
    draw, cut to size; 4:3 and 3:4 like COCO's)."""
    h, w = hw
    return synthetic_image(int(rng_for(seed, 7, index).integers(2**62)))[:h, :w].copy()


def permuted(rng: np.random.Generator, values: Sequence) -> List:
    """``values`` in an order drawn from ``rng``: the same multiset every seed."""
    return [values[i] for i in rng.permutation(len(values))]
