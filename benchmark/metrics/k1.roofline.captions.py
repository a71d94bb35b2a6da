"""K1's share of its roofline, in %: the frozen attention_bound of the
encode's [images, 50, 12, 64] in bf16 (benchmark/device.py) over K1's mean
device time per launch in the trace (`attn_kernel`)."""

from benchmark.device import kernel_mean_s


def read(rec):
    tr = rec.get("trace")
    mean = kernel_mean_s(tr, "attn_kernel") if tr else None
    if not mean:
        return None
    return 100.0 * rec["layer"]["k1_bound_ms"] / (mean * 1e3)
