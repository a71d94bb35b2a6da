"""Slot occupancy as the serving engine's host believes it, in %: its
`last_stats` counters live_slot_steps / slot_steps, over the chunks
dispatched inside the window (decode/serving.py). An upper bound on the
slots that emit."""


def read(rec):
    st = rec["layer"].get("stats")
    if not st or not st.get("slot_steps"):
        return None
    return 100.0 * st["live_slot_steps"] / st["slot_steps"]
