"""``attn_fwd_roofline_pct.train`` (%): the bound of every attention forward
the window's train steps need (vision layers x images, decoder layers x
passes; ``benchmark/lib/counting.py``) over the device time of the
attention-forward kernels below, the port's and PyTorch's SDPA kernels
alike.  Layer: kernels (``ops/flash_attention.py``).  Moves
``train_samples_per_s``."""

from benchmark.lib.readers import roofline_pct

KERNELS = ("attn_fwd_mma_kernel", "onepass_fwd_kernel", "flash_fwd_kernel",
           "flash_fwd_splitkv", "fmha_cutlassF", "efficient_attention_forward")


def read(rec):
    return roofline_pct(rec, "steps", "attn_fwd_bound_s", KERNELS)
