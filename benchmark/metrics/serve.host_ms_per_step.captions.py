"""Host time the serving engine spends issuing work, per decode step, in
ms: (dispatch_s + refill_dispatch_s) / steps of its `last_stats`, over the
chunks dispatched inside the window (decode/serving.py)."""


def read(rec):
    st = rec["layer"].get("stats")
    if not st or not st.get("steps"):
        return None
    return 1e3 * (st["dispatch_s"] + st["refill_dispatch_s"]) / st["steps"]
