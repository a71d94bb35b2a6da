"""Model operations the captions delivered in the window needed
(benchmark/flops.py), over the window times the peak of the type the LM's
products run in, in %."""


def read(rec):
    lay = rec["layer"]
    if not lay.get("model_ops"):
        return None
    return 100.0 * lay["model_ops"] / (lay["window_s"] * lay["peak_ops_per_s"])
