"""Faults planted under the timed path, to show that `correct` catches them.

Each `plant_<name>()` patches the port in this process and returns a
function that undoes the patch.

- `token`: the serving engine's sampled token is altered where it is
  produced (the next id in the vocabulary).
- `state`: a decode step leaves the KV cache as it found it: the int8
  GPT-2's decode steps never write their keys and values (the prefill's
  are), and GPT-J's decode step hands back the cache it was given, index
  unmoved, so the next step writes over the same position.
- `beam_token`: the best beam's tokens are altered where beam search
  produces them (each id moved to the next).
- `penalty_off`: the serving step's sampler (K3) runs without the
  repetition penalty.
- `top_p_wide`: the serving step's sampler keeps a nucleus of top-p 0.95
  in place of the mix's.
"""

from __future__ import annotations


def plant_token():
    from clipcap_tpu_torch.decode import serving

    orig = serving.sample_step

    def altered(settings, logits, *a, **k):
        nxt, alt, prob, eos_lp = orig(settings, logits, *a, **k)
        return (nxt + 1) % logits.shape[-1], alt, prob, eos_lp

    serving.sample_step = altered

    def undo():
        serving.sample_step = orig

    return undo


def plant_state():
    from clipcap_tpu_torch.models import gpt2, gptj

    orig = gpt2.GPT2Int8._write_kv
    orig_step = gptj.GPTJ.decode_step

    def unchanged(cache, layer, slot, k, v):
        if k.shape[1] == 1:  # a decode step: its keys and values are dropped
            return
        orig(cache, layer, slot, k, v)

    def step_unchanged(self, token_embed, cache):
        logits, _ = orig_step(self, token_embed, cache)
        return logits, cache

    gpt2.GPT2Int8._write_kv = staticmethod(unchanged)
    gptj.GPTJ.decode_step = step_unchanged

    def undo():
        gpt2.GPT2Int8._write_kv = staticmethod(orig)
        gptj.GPTJ.decode_step = orig_step

    return undo


def plant_beam_token():
    from clipcap_tpu_torch.decode import beam

    orig = beam.beam_search_batched

    def altered(*a, **k):
        res = orig(*a, **k)
        res["tokens"] = (res["tokens"] + 1) % 50257
        return res

    beam.beam_search_batched = altered

    def undo():
        beam.beam_search_batched = orig

    return undo


def _patch_sample_step(change):
    """Replace serving's sample_step by one that calls it with
    change(settings, top_p) -> (settings, top_p)."""
    from clipcap_tpu_torch.decode import serving

    orig = serving.sample_step

    def changed(settings, logits, top_k, top_p, *a, **k):
        settings, top_p = change(settings, top_p)
        return orig(settings, logits, top_k, top_p, *a, **k)

    serving.sample_step = changed

    def undo():
        serving.sample_step = orig

    return undo


def plant_penalty_off():
    import dataclasses

    return _patch_sample_step(
        lambda settings, top_p: (dataclasses.replace(settings, repetition_penalty=1.0), top_p))


def plant_top_p_wide():
    import torch

    return _patch_sample_step(lambda settings, top_p: (settings, torch.full_like(top_p, 0.95)))


FAULTS = {"token": plant_token, "state": plant_state, "beam_token": plant_beam_token,
          "penalty_off": plant_penalty_off, "top_p_wide": plant_top_p_wide}
