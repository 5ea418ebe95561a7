"""The port keeps its own copies of the JAX package's JAX-free modules.

``mimic_tpu_torch`` imports nothing of ``mimic_tpu``, not even a module there
that imports no JAX.  What it needs of those modules it holds as copies under
the same relative names.  One case per copied file holds the copy's text to
its source's, so a fix made on one side is not lost on the other; the files
that had to differ are listed with the port's lines and their reason, and
held to exactly those differences.  A last case walks every module of the port, and
``chip_smoke.py``, for imports of ``mimic_tpu``, ``jax``, ``optax`` or ``flax``.
"""

import ast
import difflib
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SRC, PORT = ROOT / "mimic_tpu", ROOT / "mimic_tpu_torch"

COPIES = [
    "config/__init__.py", "config/core.py", "config/flags.py", "config/paths.py",
    "config/presets.py",
    "models/config.py", "models/processor.py", "models/tokenizer.py",
    "data/__init__.py", "data/templates.py", "data/prefetch.py", "data/core.py",
    "data/samplers.py", "data/retrievers.py", "data/sources.py", "data/registry.py",
    "data/okvqa.py",
    "data/adapters/__init__.py", "data/adapters/base.py", "data/adapters/caption.py",
    "data/adapters/hateful_memes.py", "data/adapters/mme.py", "data/adapters/seed_bench.py",
    "data/adapters/vqa.py",
    "evaluate/__init__.py", "evaluate/base.py", "evaluate/cider.py", "evaluate/okvqa_stem.py",
    "evaluate/ptb_tokenizer.py", "evaluate/simple.py", "evaluate/vqa_accuracy.py",
    "evaluate/wordnet_morphy.py",
    "native/__init__.py", "native/image_ops.cpp", "native/ptb_tokenizer.cpp",
    "train/collate.py", "train/masking.py",
    "utils/__init__.py", "utils/naming.py", "utils/registry.py", "utils/fingerprint.py",
    "pipeline/analyze.py",
]

# file → {the port's lines where they differ from the source's: why}.  Only the
# port's side is spelled out; every differing block must be one of these.
NO_PATHS = "the port's files name no path of the machine they were written on, nor who wrote them"
DIFFERENCES = {
    "native/__init__.py": {
        '            "mimic_tpu_torch",':
            "the port builds into a cache directory of its own name",
        '            tmp = f"{so_path}.{os.getpid()}.tmp"':
            "two test workers that build at once must not write one temporary file",
    },
    "evaluate/wordnet_morphy.py": {
        "WordNet's corpus data files are not shipped with this package, so": NO_PATHS,
        "when that version is at hand.": NO_PATHS,
        "Algorithm-level equivalence with NLTK is a *machine-checked theorem*, not a\n"
        "reading of its source: the parity test instantiates NLTK's real": NO_PATHS,
        "reference pins ``nltk==3.9.1`` (its ``requirements.txt``), which\n"
        "was not at hand to confirm its ``_morphy`` body is": NO_PATHS,
    },
    "data/sources.py": {
        "of dicts whose field names match the reference's loaders so retrievers/adapters work":
            NO_PATHS,
    },
}

FORBIDDEN = ("mimic_tpu", "jax", "optax", "flax")


def _normalise_imports(text: str) -> str:
    """Absolute imports of either package as the relative ones they stand for
    would differ only in the package's name: spell both the same."""
    return text.replace("mimic_tpu_torch.", "PKG.").replace("mimic_tpu.", "PKG.")


def _differing_blocks(src: str, port: str):
    """The port's side of every block of lines that differs from the source."""
    ours = port.splitlines()
    matcher = difflib.SequenceMatcher(None, src.splitlines(), ours, autojunk=False)
    return ["\n".join(ours[j1:j2]) for tag, _, _, j1, j2 in matcher.get_opcodes() if tag != "equal"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_source(rel):
    src, port = (SRC / rel).read_text(), (PORT / rel).read_text()
    blocks = _differing_blocks(_normalise_imports(src), _normalise_imports(port))
    assert sorted(blocks) == sorted(DIFFERENCES.get(rel, {})), (
        f"mimic_tpu_torch/{rel} differs from mimic_tpu/{rel}: copy the change over, or list "
        f"the port's lines and the reason in DIFFERENCES")


def test_image_key_copy_equals_its_source():
    """``models/feature_cache.py`` is a port (its cache encodes through torch),
    but the content keys it and ``train/collate.py`` use must stay those of
    the JAX package: ``image_key``'s text is held to its source's."""

    def function_source(path):
        text = path.read_text()
        node = next(n for n in ast.parse(text).body
                    if isinstance(n, ast.FunctionDef) and n.name == "image_key")
        return ast.get_source_segment(text, node)

    rel = "models/feature_cache.py"
    assert function_source(PORT / rel) == function_source(SRC / rel)


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_nothing_of_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 60
    bad = [(str(f.relative_to(ROOT)), line, root) for f in files
           for root, line in _imported_roots(f) if root in FORBIDDEN]
    assert not bad, bad
    # nor by name at run time: no importlib / __import__ of them
    by_name = re.compile(r"""(import_module|__import__)\(\s*["'](%s)["'.]""" % "|".join(FORBIDDEN))
    for f in files:
        assert not by_name.search(f.read_text()), f
    assert not (PORT / "shared.py").exists()
