"""Device time of the beam search per decode step, in ms: the device
operations that started inside each call's beam loop (from
beam_search_batched's call to the copy of its beams to the host; the
prefill and the first expansion included), over the calls' decode steps
(max_new_tokens - 1 each)."""


def read(rec):
    lay = rec["layer"]
    if lay.get("beam_device_s") is None or not lay.get("calls"):
        return None
    return 1e3 * lay["beam_device_s"] / (lay["calls"] * lay["beam_steps"])
