"""``mla_attn_fwd_roofline_pct.train`` (%): the bound of the latent-attention
forward calls the window's train steps need (``mla_attn_fwd_bound_s`` of
``benchmark/flops/<family>.py``: the decoder's calls of both passes, query
and key heads 192 wide and value heads 128) over the device time of the
kernel instantiated for those widths, whose name is its own.  None where no
such kernel ran.  Layer: kernels (``ops/flash_attention.py``).  Moves
``train_samples_per_s``."""

from benchmark.lib.readers import roofline_pct

KERNELS = ("mla_attn_fwd_mma_kernel",)


def read(rec):
    return roofline_pct(rec, "steps", "mla_attn_fwd_bound_s", KERNELS)
