"""K3's share of its roofline, in %: the frozen sampler_bound at the
serving batch (benchmark/device.py) over K3's mean device time per launch
in the trace (the `sampler_kernel` launches: serving runs K3 alone)."""

from benchmark.device import kernel_mean_s


def read(rec):
    tr = rec.get("trace")
    mean = kernel_mean_s(tr, "sampler_kernel") if tr else None
    if not mean:
        return None
    return 100.0 * rec["layer"]["k3_bound_ms"] / (mean * 1e3)
