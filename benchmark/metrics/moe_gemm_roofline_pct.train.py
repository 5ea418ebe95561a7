"""``moe_gemm_roofline_pct.train`` (%): the bound of the routed experts'
grouped products the window's train steps need (``moe_gemm_bound_s`` of
``benchmark/flops/<family>.py``: gate, up and down a layer in both passes,
and the same three against the transposed weights in the shift pass's
backward, each call reading every expert's weights once) over the device
time of the kernels that ran them: ``torch._grouped_mm``'s CUTLASS grouped
GEMM (its name holds ``GroupProblemShape``) and the kernel that prepares its
groups' pointers, as an H100's trace names them.  None where no such kernel
ran.  Layer: kernels (``models/moe.py``).  Moves ``train_samples_per_s``."""

from benchmark.lib.readers import roofline_pct

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(rec):
    return roofline_pct(rec, "steps", "moe_gemm_bound_s", KERNELS)
