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
KIMI = ("Kimi-VL (latent attention, routed experts, MoonViT at native resolution) is "
        "the port's alone: the JAX package has no such model; the processor and the "
        "collator pass each row's images to expand_image_tokens for its sizes")
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
    "models/config.py": {
        (
            "    # multi-head latent attention (DeepSeek-V3's, Kimi-VL's; on when kv_lora_rank\n"
            '    # is set): q heads of qk_nope + qk_rope, one shared rope key, k_nope and v\n'
            '    # from an RMS-normed latent of kv_lora_rank\n'
            '    kv_lora_rank: Optional[int] = None\n'
            '    qk_nope_head_dim: int = 0\n'
            '    qk_rope_head_dim: int = 0\n'
            '    v_head_dim: int = 0\n'
            '    # routed experts (on when n_routed_experts is set) in the layers from\n'
            '    # first_k_dense_replace on: sigmoid scores, the top num_experts_per_tok by\n'
            '    # score plus a correction bias, their scores normalised and scaled by\n'
            "    # routed_scaling_factor, and n_shared_experts experts' width on every token\n"
            '    n_routed_experts: Optional[int] = None\n'
            '    num_experts_per_tok: int = 0\n'
            '    moe_intermediate_size: int = 0\n'
            '    n_shared_experts: int = 0\n'
            '    first_k_dense_replace: int = 0\n'
            '    routed_scaling_factor: float = 1.0\n'
            '\n'
            '    @property\n'
            '    def qk_head_size(self) -> int:\n'
            '        mla = self.kv_lora_rank is not None\n'
            '        return self.qk_nope_head_dim + self.qk_rope_head_dim if mla else self.head_size\n'
            '\n'
            '    @property\n'
            '    def v_head_size(self) -> int:\n'
            '        return self.v_head_dim if self.kv_lora_rank is not None else self.head_size\n'
            '\n'
            '    @property\n'
            '    def num_moe_layers(self) -> int:\n'
            '        if self.n_routed_experts is None:\n'
            '            return 0\n'
            '        return self.num_layers - self.first_k_dense_replace'
        ): KIMI,
        (
            '    # MoonViT (Kimi-VL): each image at its own resolution (image_size / patch_size\n'
            "    # is the side of the position table, interpolated to each image's patch grid),\n"
            '    # at most in_token_limit patches an image, 2D RoPE (rope_theta) on q and k, and\n'
            '    # merge_kernel x merge_kernel patches merged into one token\n'
            '    in_token_limit: int = 0\n'
            '    merge_kernel: int = 1\n'
            '    rope_theta: float = 10000.0'
        ): KIMI,
        (
            '    if family == "kimi-vl":\n'
            '        return tiny_kimi_vl(**kw)'
        ): KIMI,
        (
            'def kimi_vl_a3b_instruct() -> ModelConfig:\n'
            '    """Kimi-VL-A3B-Instruct: a DeepSeek-V3-style tower (MLA without a q LoRA,\n'
            '    64 routed experts and 2 shared ones from layer 1 on) and MoonViT at native\n'
            '    resolution with a 2 x 2 patch merge and an MLP projector."""\n'
            '    return ModelConfig(\n'
            '        name="kimi-vl-a3b-instruct",\n'
            '        family="kimi-vl",\n'
            '        text=TextConfig(\n'
            '            vocab_size=163840,\n'
            '            hidden_size=2048,\n'
            '            num_layers=27,\n'
            '            num_heads=16,\n'
            '            num_kv_heads=16,\n'
            '            intermediate_size=11264,\n'
            '            norm_eps=1e-5,\n'
            '            rope_theta=800000.0,\n'
            '            max_position_embeddings=131072,\n'
            '            kv_lora_rank=512,\n'
            '            qk_nope_head_dim=128,\n'
            '            qk_rope_head_dim=64,\n'
            '            v_head_dim=128,\n'
            '            n_routed_experts=64,\n'
            '            num_experts_per_tok=6,\n'
            '            moe_intermediate_size=1408,\n'
            '            n_shared_experts=2,\n'
            '            first_k_dense_replace=1,\n'
            '            routed_scaling_factor=2.446,\n'
            '        ),\n'
            '        vision=VisionConfig(\n'
            '            hidden_size=1152,\n'
            '            num_layers=27,\n'
            '            num_heads=16,\n'
            '            intermediate_size=4304,\n'
            '            image_size=64 * 14,  # the 64 x 64 position table\n'
            '            patch_size=14,\n'
            '            norm_eps=1e-5,\n'
            '            hidden_act="gelu_tanh",\n'
            '            in_token_limit=4096,\n'
            '            merge_kernel=2,\n'
            '        ),\n'
            '    )\n'
            '\n'
            '\n'
            'def tiny_kimi_vl(**kw) -> ModelConfig:\n'
            '    """``kimi_vl_a3b_instruct``\'s structure at test widths: q/k heads 24 wide,\n'
            '    v heads 16, 8 experts (3 a token), an 8 x 8 position table."""\n'
            '    text = dict(\n'
            '        vocab_size=256, hidden_size=64, num_layers=3, num_heads=4, num_kv_heads=4,\n'
            '        intermediate_size=128, rope_theta=800000.0, kv_lora_rank=16, qk_nope_head_dim=16,\n'
            '        qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=3,\n'
            '        moe_intermediate_size=32, n_shared_experts=1, first_k_dense_replace=1,\n'
            '        routed_scaling_factor=2.446,\n'
            '    )\n'
            '    text.update(kw)\n'
            '    return ModelConfig(\n'
            '        name="tiny-kimi-vl",\n'
            '        family="kimi-vl",\n'
            '        text=TextConfig(**text),\n'
            '        vision=VisionConfig(\n'
            '            hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,\n'
            '            image_size=8 * 14, patch_size=14, norm_eps=1e-5, in_token_limit=64,\n'
            '            merge_kernel=2,\n'
            '        ),\n'
            '        image_token_id=250, pad_token_id=0, bos_token_id=1, eos_token_id=2,\n'
            '    )\n'
            '\n'
            ''
        ): KIMI,
        '    "kimi-vl-a3b-instruct": kimi_vl_a3b_instruct,': KIMI,
    },
    "models/processor.py": {
        '    def expand_image_tokens(self, text: str, images=None) -> str:': KIMI,
    },
    "train/collate.py": {
        (
            '    def _pad_to(self, texts: List[str], limit: Optional[int], images=None) -> Optional[int]:\n'
            "        # the images: where an image's token count follows its size (Kimi-VL)"
        ): KIMI,
        (
            '            len(self.tk.encode(self.proc.expand_image_tokens(t, imgs), add_bos=True))\n'
            '            for t, imgs in zip(texts, images or [None] * len(texts))'
        ): KIMI,
        '            pad_to=self._pad_to(query_answer, self.max_query_len, query_images),': KIMI,
        '            pad_to=self._pad_to(full, self.max_full_len, images),': KIMI,
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


def _public_names(path: Path):
    """The public top-level functions and classes a module defines."""
    return {n.name for n in ast.parse(path.read_text(), filename=str(path)).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def test_every_module_of_the_jax_package_has_a_counterpart():
    """The port is whole: each module of ``mimic_tpu`` has one of the same
    relative name in ``mimic_tpu_torch`` (copied or ported), and each public
    top-level function and class of it one of the same name there (no
    exceptions: the private Pallas bodies are not public names)."""
    modules = [p.relative_to(SRC) for p in SRC.rglob("*.py") if "__pycache__" not in p.parts]
    missing = sorted(str(rel) for rel in modules if not (PORT / rel).exists())
    assert not missing, missing
    names = {str(rel): sorted(_public_names(SRC / rel) - _public_names(PORT / rel))
             for rel in modules}
    assert not {rel: n for rel, n in names.items() if n}, names
