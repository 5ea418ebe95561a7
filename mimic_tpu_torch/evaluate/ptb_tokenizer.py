"""Pure-Python Penn-Treebank-style tokenizer for caption scoring.

Replaces the reference's Java subprocess
(``testbed/evaluate/metrics/CIDEr/CIDEr.py:59-120`` shells out to Stanford-CoreNLP's
``edu.stanford.nlp.process.PTBTokenizer -preserveLines -lowerCase`` then removes a
fixed punctuation list).  This implementation reproduces the PTB tokenization rules
(Stanford default ``ptb3Escaping`` behavior) that matter for English captions:

- terminal/clause punctuation split off (``.`` ``,`` ``?`` ``!`` ``;`` ``:``)
- ellipsis ``...`` (and U+2026) kept as one token; em/en dashes → ``--``
- brackets mapped to ``-LRB-``/``-RRB-``/``-LCB-``/``-RCB-``/``-LSB-``/``-RSB-``
- double quotes mapped to opening/closing backtick forms; single quotes to an
  opening backtick / closing apostrophe (all stripped by the caption pipeline)
- contractions split recursively: ``n't`` ``'s`` ``'m`` ``'re`` ``'ve`` ``'ll`` ``'d``
- PTB special splits: ``cannot → can not``, ``gonna → gon na``, ``gotta``,
  ``wanna``, ``lemme``, ``gimme``, ``more'n``, ``'tis``, ``'twas``, ``d'ye``
- hyphenated compounds kept whole incl. digit segments (``3-year-old``,
  ``10,000-dollar``); numbers keep internal ``.``/``,`` between digits
- letter-period acronyms (``u.s.``, ``a.m.``) and title abbreviations (``mr.``,
  ``dr.``, …) keep their periods
- a word's trailing apostrophe (``dogs'``) splits off as a ``'`` token

Validated three ways (tests/test_native_tokenizer.py, test_ptb_golden.py):
a committed golden corpus (tests/fixtures/ptb_golden.json), cross-checked
against NLTK's TreebankWordTokenizer (an independent PTB implementation) on the
word-boundary subset where the conventions coincide, and Python↔C++ twin parity.

Known deviations from Stanford (documented, outside caption vocabulary):
no email/URL single-token rule, no sentence-final abbreviation period
duplication (the duplicate ``.`` is stripped by the pipeline anyway), no
signed-number rule (``-5`` → ``-`` ``5``).
"""

from __future__ import annotations

from typing import List

# punctuation tokens removed after tokenization, mirroring the reference list
PUNCTUATIONS = frozenset(
    ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
     ".", "?", "!", ",", ":", "-", "--", "...", ";"]
)

_BRACKETS = {
    "(": "-LRB-", ")": "-RRB-",
    "{": "-LCB-", "}": "-RCB-",
    "[": "-LSB-", "]": "-RSB-",
}

# PTB sed-script special splits (Stanford follows these)
SPECIAL_SPLITS = {
    "cannot": ["can", "not"],
    "gonna": ["gon", "na"],
    "gotta": ["got", "ta"],
    "wanna": ["wan", "na"],
    "lemme": ["lem", "me"],
    "gimme": ["gim", "me"],
    "more'n": ["more", "'n"],
    "'tis": ["'t", "is"],
    "'twas": ["'t", "was"],
    "d'ye": ["d'", "ye"],
    "whaddya": ["wha", "dd", "ya"],
    "whatcha": ["wha", "t", "cha"],
}

# common title/unit abbreviations that keep their period (subset of Stanford's
# ABBREV lexicon relevant to caption/VQA vocabulary)
TITLE_ABBREVS = frozenset(
    ["mr", "mrs", "ms", "dr", "prof", "rev", "gen", "sen", "rep", "gov",
     "st", "jr", "sr", "capt", "col", "sgt", "lt", "maj", "vs", "etc",
     "inc", "ltd", "co", "corp", "ft", "oz", "lb", "lbs"]
)

_CLAUSE_PUNCT = set(",;:@#$%&")
_CLITICS3 = ("n't", "'re", "'ve", "'ll")
_CLITICS2 = ("'s", "'m", "'d")


def _is_word_char(ch: str) -> bool:
    return ch.isalnum() or ch == "_" or ord(ch) >= 0x80


def _split_contractions(token: str, out: List[str]) -> None:
    if token in SPECIAL_SPLITS:
        out.extend(SPECIAL_SPLITS[token])
        return
    n = len(token)
    for suf in _CLITICS3:
        if n > 3 and token.endswith(suf) and _is_word_char(token[n - 4]):
            _split_contractions(token[: n - 3], out)
            out.append(token[n - 3:])
            return
    for suf in _CLITICS2:
        if n > 2 and token.endswith(suf) and _is_word_char(token[n - 3]):
            _split_contractions(token[: n - 2], out)
            out.append(token[n - 2:])
            return
    out.append(token)


def ptb_tokenize(line: str, lowercase: bool = True) -> List[str]:
    """Tokenize one caption line; returns the token list including punctuation.

    Dispatches to the C++ implementation (``mimic_tpu.native``) when available —
    the Python path below is the behavioral oracle and fallback.
    """
    from ..native import ptb_tokenize_native

    native = ptb_tokenize_native(line, lowercase)
    if native is not None:
        return native
    return ptb_tokenize_py(line, lowercase)


def ptb_tokenize_py(line: str, lowercase: bool = True) -> List[str]:
    """Pure-Python reference implementation (mirrors native/ptb_tokenizer.cpp)."""
    if lowercase:
        line = line.lower()
    # unicode normalization (Stanford ptb3Escaping equivalents)
    line = (
        line.replace("\n", " ")
        .replace("’", "'").replace("‘", "'")
        .replace("“", '"').replace("”", '"')
        .replace("…", "...")
        .replace("—", "--").replace("–", "--")
    )
    tokens: List[str] = []
    i, n = 0, len(line)
    prev_is_boundary = True  # start-of-line / after whitespace (quote side)
    while i < n:
        c = line[i]
        if c.isspace():
            i += 1
            prev_is_boundary = True
            continue
        start_boundary = prev_is_boundary
        prev_is_boundary = False
        # ellipsis
        if line.startswith("...", i):
            tokens.append("...")
            i += 3
            continue
        # dash runs
        if c == "-" and i + 1 < n and line[i + 1] == "-":
            j = i
            while j < n and line[j] == "-":
                j += 1
            tokens.append(line[i:j])
            i = j
            continue
        # clause punctuation / symbols
        if c in _CLAUSE_PUNCT:
            tokens.append(c)
            i += 1
            continue
        # letter-period acronym (u.s., a.m.): single letters each followed by
        # a period, at least two groups, not running into a longer word
        if c.isalpha() and i + 1 < n and line[i + 1] == ".":
            j, groups = i, 0
            while j + 1 < n and line[j].isalpha() and line[j + 1] == ".":
                j += 2
                groups += 1
            if groups >= 2 and (j >= n or not _is_word_char(line[j])):
                tokens.append(line[i:j])
                i = j
                continue
        # word / number with internal joiners
        if _is_word_char(c):
            j = i
            while j < n:
                ch = line[j]
                if _is_word_char(ch):
                    j += 1
                elif ch in "-'" and j + 1 < n and _is_word_char(line[j + 1]):
                    j += 2
                elif (
                    ch in ".,"
                    and j > i
                    and line[j - 1].isdigit()
                    and j + 1 < n
                    and line[j + 1].isdigit()
                ):
                    j += 2
                else:
                    break
            word = line[i:j]
            trailing_quote = False
            if j < n and line[j] == "'":
                # dogs' -> dogs + ' (possessive plural; Stanford splits it)
                trailing_quote = True
                j += 1
            # title abbreviation keeps its period
            if (
                j < n
                and line[j] == "."
                and not trailing_quote
                and word in TITLE_ABBREVS
            ):
                word += "."
                j += 1
            _split_contractions(word, tokens)
            if trailing_quote:
                tokens.append("'")
            i = j
            continue
        # brackets
        if c in _BRACKETS:
            tokens.append(_BRACKETS[c])
            i += 1
            continue
        # apostrophe-leading PTB specials ('tis, 'twas)
        if c == "'" and i + 1 < n and _is_word_char(line[i + 1]):
            j = i + 1
            while j < n and _is_word_char(line[j]):
                j += 1
            lead = line[i:j]
            if lead in SPECIAL_SPLITS:
                tokens.extend(SPECIAL_SPLITS[lead])
                i = j
                continue
        # quotes: side-aware PTB forms
        if c == '"':
            tokens.append("``" if start_boundary else "''")
            i += 1
            continue
        if c == "'":
            tokens.append("`" if start_boundary else "'")
            i += 1
            prev_is_boundary = start_boundary  # 'hello: quote then word
            continue
        # any other single non-space char
        tokens.append(c)
        i += 1
    return tokens


def tokenize_for_caption_metrics(line: str) -> str:
    """Full caption pipeline: PTB tokenize, lowercase, drop punctuation tokens."""
    return " ".join(t for t in ptb_tokenize(line) if t not in PUNCTUATIONS)
