"""mimic_tpu_torch.native: the port's copy of the C++ helpers (PTB tokenizer,
bit-exact PIL resize) and its ``g++`` loader.

These tests never skip on the state of a cache, and never read the user's: a
fixture points the loader at an empty cache directory of this test run, where
the library is built if ``g++`` exists (availability is asserted to equal
that), and the pure-Python fallbacks are held to the native results.  The
loader writes each build to a temporary file of its own process, so several
processes that find the cache cold at once (test workers importing together)
all end with a loadable library; a subprocess case starts four on an empty
cache directory.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from mimic_tpu_torch import native
from mimic_tpu_torch.evaluate import ptb_tokenizer as tptb
from mimic_tpu_torch.models.processor import ImageProcessor

HAS_GXX = shutil.which("g++") is not None
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LINES = [
    "A man riding a wave on top of a surfboard.",
    "it's a \"quoted\" caption -- with dashes, commas; and (brackets)!",
    "Two dogs (one brown) can't catch the frisbee...",
    "  extra   spaces\tand tabs  ",
    "",
    "U.S.A. costs $3.50 & 10% more",
]


@pytest.fixture(scope="module", autouse=True)
def own_cache(tmp_path_factory):
    """Build into a cache directory of this module, whatever the user's holds
    or allows; afterwards the loader starts afresh for whoever comes next."""
    patch = pytest.MonkeyPatch()
    patch.setenv("XDG_CACHE_HOME", str(tmp_path_factory.mktemp("native_cache")))
    patch.delenv("MIMIC_TPU_NO_NATIVE", raising=False)
    patch.setattr(native, "_lib", None)
    patch.setattr(native, "_tried", False)
    yield
    patch.undo()
    native._lib, native._tried = None, False


def test_native_builds_wherever_gxx_exists():
    assert native.native_available() == HAS_GXX


@pytest.mark.parametrize("lowercase", [True, False])
@pytest.mark.parametrize("line", LINES)
def test_ptb_python_fallback_equals_native(line, lowercase):
    want = tptb.ptb_tokenize_py(line, lowercase)
    got = native.ptb_tokenize_native(line, lowercase)
    if HAS_GXX:
        assert got == want
    else:
        assert got is None
    assert tptb.ptb_tokenize(line, lowercase) == want


@pytest.mark.parametrize("resample,pil", [("bilinear", Image.BILINEAR), ("bicubic", Image.BICUBIC)])
@pytest.mark.parametrize("src,dst", [((100, 50), (28, 28)), ((10, 10), (64, 48)), ((7, 13), (13, 7))])
def test_resize_equals_pil_bit_for_bit(src, dst, resample, pil):
    arr = np.random.default_rng(sum(src + dst)).integers(0, 256, size=src + (3,), dtype=np.uint8)
    got = native.resize_native(arr, *dst, resample)
    if not HAS_GXX:
        assert got is None
        return
    want = np.asarray(Image.fromarray(arr).resize((dst[1], dst[0]), pil))
    np.testing.assert_array_equal(got, want)


def test_image_processor_matches_the_pil_path():
    proc = ImageProcessor(size=28, mode="longest_edge", min_size=1)
    img = np.random.default_rng(0).integers(0, 256, size=(100, 50, 3), dtype=np.uint8)
    arr, (vh, vw) = proc.process_with_region(img)
    assert (vh, vw) == (28, 14)
    resized = np.asarray(Image.fromarray(img).resize((14, 28), Image.BILINEAR))
    expected = np.zeros((28, 28, 3), np.float32)
    expected[:, :14] = (resized.astype(np.float32) / 255.0 - 0.5) / 0.5
    np.testing.assert_allclose(arr, expected, rtol=0, atol=1e-6)


def test_four_processes_on_a_cold_cache_all_load_the_library(tmp_path):
    """Each process compiles to its own temporary file and moves it into place
    atomically, so none loads a half-written library."""
    code = ("from mimic_tpu_torch import native; import sys; "
            "ok = native.native_available(); "
            "print(ok, native.ptb_tokenize_native('a (b) c.') if ok else None); "
            "sys.exit(0)")
    env = dict(os.environ, XDG_CACHE_HOME=str(tmp_path))
    env.pop("MIMIC_TPU_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    want = f"{HAS_GXX} {native.ptb_tokenize_native('a (b) c.') if HAS_GXX else None}"
    assert [o.strip() for o, _ in outs] == [want] * 4
    built = os.listdir(tmp_path / "mimic_tpu_torch") if HAS_GXX else []
    assert [f for f in built if f.endswith(".tmp")] == [] and len(built) == int(HAS_GXX)


def test_no_native_switch_falls_back_to_python(tmp_path):
    code = ("from mimic_tpu_torch import native; "
            "from mimic_tpu_torch.evaluate.ptb_tokenizer import ptb_tokenize; "
            "print(native.native_available(), ptb_tokenize('It\\'s here.'))")
    env = dict(os.environ, MIMIC_TPU_NO_NATIVE="1", XDG_CACHE_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"False {tptb.ptb_tokenize_py('It' + chr(39) + 's here.', True)}"
    assert not os.path.exists(tmp_path / "mimic_tpu_torch")
