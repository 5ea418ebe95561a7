"""``attn_fwd_roofline_pct.eval`` (%): the bound of every attention forward
of the window's generate calls (vision rows and the prefill; the decode
steps' cached attention is no kernel of this list) over the device time of
the attention-forward kernels below.  Layer: kernels
(``ops/flash_attention.py``).  Moves ``eval_questions_per_s``."""

from benchmark.lib.readers import roofline_pct

KERNELS = ("attn_fwd_mma_kernel", "onepass_fwd_kernel", "flash_fwd_kernel",
           "flash_fwd_splitkv", "fmha_cutlassF", "efficient_attention_forward")


def read(rec):
    return roofline_pct(rec, "calls", "attn_fwd_bound_s", KERNELS)
