"""Official VQAv2 accuracy protocol.

Behavioral parity with the reference metric
(``testbed/evaluate/metrics/vqa_accuracy/vqa_accuracy.py:200-310``), which itself
follows the official GT-Vision-Lab/VQA evaluation code: answers are normalized
(punctuation / digit words / articles / contractions), then accuracy is the mean over
all leave-one-annotator-out subsets of ``min(#matching/3, 1)``, reported ×100 with
optional per-answer-type and per-question-type breakdowns.

The normalization tables below are the official VQA evaluation constants
(https://github.com/GT-Vision-Lab/VQA) — they must match bit-for-bit for score parity.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

from .base import Metric

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't", "notve": "not've",
    "oclock": "o'clock", "oughtnt": "oughtn't", "ow's'at": "'ow's'at",
    "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at", "shant": "shan't",
    "shed've": "she'd've", "she'dve": "she'd've", "she's": "she's",
    "shouldve": "should've", "shouldnt": "shouldn't", "shouldnt've": "shouldn't've",
    "shouldn'tve": "shouldn't've", "somebody'd": "somebodyd",
    "somebodyd've": "somebody'd've", "somebody'dve": "somebody'd've",
    "somebodyll": "somebody'll", "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't", "whatll": "what'll",
    "whatre": "what're", "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've", "yall": "y'all",
    "yall'll": "y'all'll", "y'allll": "y'all'll", "yall'd've": "y'all'd've",
    "y'alld've": "y'all'd've", "y'all'dve": "y'all'd've", "youd": "you'd",
    "youd've": "you'd've", "you'dve": "you'd've", "youll": "you'll",
    "youre": "you're", "youve": "you've",
}

DIGIT_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}

ARTICLES = ("a", "an", "the")

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")

PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


def process_punctuation(text: str) -> str:
    """Official punctuation handling: a punct char flanked by a space (or any text with
    a digit,digit comma) is deleted, otherwise replaced by a space; then periods not in
    numbers are stripped."""
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or _COMMA_STRIP.search(text) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    # NOTE: the official code calls ``periodStrip.sub("", out, re.UNICODE)`` where
    # re.UNICODE (=32) lands in the *count* argument — we reproduce that exact
    # behavior (at most 32 period replacements) for bit-for-bit parity.
    out = _PERIOD_STRIP.sub("", out, 32)
    return out


def process_digit_article(text: str) -> str:
    words = []
    for word in text.lower().split():
        word = DIGIT_MAP.get(word, word)
        if word not in ARTICLES:
            words.append(word)
    for i, word in enumerate(words):
        if word in CONTRACTIONS:
            words[i] = CONTRACTIONS[word]
    return " ".join(words)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


def vqa_sample_accuracy(prediction: str, references: List[str]) -> float:
    """min(#match/3, 1) averaged over leave-one-annotator-out subsets."""
    pred = normalize_answer(prediction)
    gts = [process_digit_article(process_punctuation(gt)) for gt in references]
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1 :]
        matching = [g for g in others if g == pred]
        accs.append(min(1.0, len(matching) / 3))
    return sum(accs) / len(accs)


class VQAAccuracy(Metric):
    """VQA accuracy with overall / perAnswerType / perQuestionType keys (×100)."""

    def _compute(self, rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        total: List[float] = []
        by_ans: Dict[str, List[float]] = {}
        by_ques: Dict[str, List[float]] = {}
        for row in rows:
            acc = vqa_sample_accuracy(row["prediction"], row["reference"])
            total.append(acc)
            ans_type = row.get("answer_types")
            ques_type = row.get("question_types")
            if ans_type is not None:
                by_ans.setdefault(ans_type, []).append(acc)
            if ques_type is not None:
                by_ques.setdefault(ques_type, []).append(acc)

        result: Dict[str, Any] = {"overall": 100 * sum(total) / len(total)}
        if by_ans:
            result["perAnswerType"] = {
                k: 100 * sum(v) / len(v) for k, v in by_ans.items()
            }
        if by_ques:
            result["perQuestionType"] = {
                k: 100 * sum(v) / len(v) for k, v in by_ques.items()
            }
        return result
