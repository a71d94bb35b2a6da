"""The routed experts' grouped products against their roofline, in %: the
least time the card could take for the window's MoE calls
(benchmark/moe_flops.py `expert_gemm_bound_s`: each hit expert's weights
read once, the routed tokens in and out, over HBM bandwidth; or the
operations over the bf16 peak) over the device time of the grouped GEMM
kernels in the trace (moe_flops.EXPERT_KERNELS). Above 100 % the count
misses a launch."""


def read(rec):
    lay = rec.get("layer") or {}
    moe, kernel_s = lay.get("moe"), lay.get("moe_expert_kernel_s")
    if not moe or not kernel_s:
        return None
    return 100.0 * moe["bound_s"] / kernel_s
