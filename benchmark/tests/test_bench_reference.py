"""The plain reference against ``mimic_tpu_torch`` in float32 on the CPU at
tiny sizes (one MimIC cell's first steps of each family, and beam-3 calls),
and its image preprocessing against PIL and the port's processor."""

import numpy as np
import pytest
import torch

from benchmark.tests import tiny
from benchmark.lib import harness
from benchmark.reference import plain

PIL = pytest.importorskip("PIL.Image")


@pytest.mark.parametrize("resample", ["bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", [((480, 640), (735, 980)), ((640, 427), (384, 384)),
                                     ((100, 50), (28, 28)), ((7, 13), (13, 7))])
def test_bench_resize_is_pils(resample, src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, size=src + (3,), dtype=np.uint8)
    flt = PIL.BILINEAR if resample == "bilinear" else PIL.BICUBIC
    want = np.asarray(PIL.fromarray(img).resize(dst[::-1], flt))
    np.testing.assert_array_equal(plain.resize(img, *dst, resample), want)


@pytest.mark.parametrize("cfg_name,shape", [("idefics2-8b-base", (480, 640)),
                                            ("idefics2-8b-base", (640, 427)),
                                            ("llava-interleave-7b", (480, 640))])
def test_bench_image_processing_is_the_ports(cfg_name, shape):
    from benchmark.lib import registry
    from mimic_tpu_torch.models.config import get_model_config
    from mimic_tpu_torch.models.processor import LVLMProcessor
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer

    cfg = registry.config(cfg_name)
    img = np.random.default_rng(1).integers(0, 256, size=shape + (3,), dtype=np.uint8)
    proc = LVLMProcessor(get_model_config(cfg["program_model"]), SimpleTokenizer())
    out = proc([[img]], ["<image>x"])
    px, mask = plain.process_image(img, cfg["processor"], cfg["vision_config"]["patch_size"])
    np.testing.assert_array_equal(out["pixel_values"][0, 0], px)
    if mask is None:
        assert "patch_mask" not in out
    else:
        np.testing.assert_array_equal(out["patch_mask"][0, 0], mask)


def run_tiny(wl, cfg, limits):
    import time
    return harness.run_cell(wl, cfg, 2**31 + 7, 0.5, False, tiny.CPU,
                            time.perf_counter(), limits, dtype=torch.float32)


@pytest.mark.parametrize("family", ["idefics2", "llava_interleave"])
def test_bench_reference_follows_the_train_step(family):
    wl, cfg = tiny.train_cell(family)
    r = run_tiny(wl, cfg, {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-3})
    assert r["correct"], r["checks"]


def test_bench_reference_scores_the_beams():
    wl, cfg = tiny.eval_cell()
    # a served beam token is among its parent's top 2 x beams = 6
    r = run_tiny(wl, cfg, {"score_gap": 1e-4, "token_rank": 5})
    assert r["correct"], r["checks"]
