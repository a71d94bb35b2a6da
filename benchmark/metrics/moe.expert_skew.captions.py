"""How far the most-loaded routed expert lies above the mean, as a ratio:
the window's mean over MoE calls of the most tokens any expert received
over the mean tokens an expert receives (the call's token-expert pairs
over the experts), from the port's expert log (`DeepseekV3.log_experts`,
each MoE call's tokens per expert, benchmark/drivers/serve_large.py). The
most-loaded expert sets a grouped product's tail."""


def read(rec):
    moe = (rec.get("layer") or {}).get("moe")
    if not moe:
        return None
    e = moe["experts"]
    ratios = [top / (pairs / e) for top, pairs in zip(moe["max_expert_tokens"], moe["pairs"])
              if pairs]
    return sum(ratios) / len(ratios) if ratios else None
