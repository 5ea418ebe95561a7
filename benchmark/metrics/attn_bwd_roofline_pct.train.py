"""``attn_bwd_roofline_pct.train`` (%): the bound of the shift pass's
attention backward calls (layers 1..L-1) over the device time of the
attention-backward kernels below.  Layer: kernels
(``ops/flash_backward.py``).  Moves ``train_samples_per_s``."""

from benchmark.lib.readers import roofline_pct

KERNELS = ("bwd_dq_mma_kernel", "bwd_dkv_mma_kernel", "flash_bwd_dq_kernel",
           "flash_bwd_dkv_kernel", "flash_bwd", "fmha_cutlassB", "efficient_attention_backward")


def read(rec):
    return roofline_pct(rec, "steps", "attn_bwd_bound_s", KERNELS)
