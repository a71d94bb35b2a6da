"""95th percentile of each request's wait before a slot takes it, in s: the
harness's latency (scheduled arrival to harvest) minus the engine's own
`latency_s` (slot assignment to harvest)."""


def read(rec):
    return rec["layer"].get("queue_wait_p95_s")
