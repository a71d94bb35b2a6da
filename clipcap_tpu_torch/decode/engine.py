"""KV-cached autoregressive generation (port of clipcap_tpu/decode/engine.py).

`generate` runs settings.max_new_tokens steps over a fixed-shape batch:
finished rows are masked, never spliced out, as in the JAX engine. All
hyperparameters accept scalars or per-row [B] vectors.

Path selection is the JAX engine's (engine.py:155-179, :288-299) with "on
a TPU" read as "on CUDA":
- on CUDA, the sampled step of filter_method="fused" launches the fused
  filter + sampler kernel K2, and "fused_step" launches K3, which also runs
  the eos logprob, min-length suppression, repetition penalty and
  temperature in the kernel;
- on the CPU, and wherever the kernels do not apply (greedy, an active
  typ_p or sentence-length penalty), the step takes the threshold path,
  exactly as the JAX engine does on the CPU;
- filter_method="sort" takes the sort-based filters (ops/sampling.py:
  top_k_top_p_filter with settings.vocab_prefilter, typical_filter) on
  every device, as the JAX engine does; no kernel runs there.

Randomness: `seed` seeds a `StepRandomness`: a `torch.Generator` for the
Gumbel draws of the threshold path and the per-step seeds of the kernels'
Philox generator. `gumbel_noise` [N, B, V] injects the per-step draws
instead (tests feed JAX's `jax.random.gumbel` draws to reproduce its
trajectories). The per-step pipeline (`sample_step`) and completion logic
(`complete_step`) are shared with the serving chunk (decode/serving.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from ..ops import sampling as S
from ..ops.kernels.fused_sampler import fused_filter_sample, fused_step_sample

Scalar = Union[float, int, torch.Tensor, Sequence[float]]
BIG = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class GenerationSettings:
    """Decode hyperparameters (scalars broadcast; sequences are per-row)."""

    max_new_tokens: int = 67  # reference inference.py entry_length default
    temperature: float = 1.0
    top_k: Scalar = 0
    top_p: Scalar = 0.0
    typ_p: Scalar = 0.0
    repetition_penalty: float = 1.0
    greedy: bool = False

    # '.'-style stopping (reference inference.py:284, evaluate_model.py:169)
    stop_token_id: Optional[int] = None
    max_stops: int = 1
    stop_on_special: Tuple[int, ...] = ()  # tokenizer.all_special_ids

    # Gen-B controls (reference sampling.py:166-279)
    eos_token_id: Optional[int] = None
    min_length: Scalar = 0  # suppress EOS before this many new tokens
    max_length: Scalar = BIG  # per-row cap on new tokens
    force_eos_log_prob: float = 0.0  # < 0 activates early stop on high raw EOS prob
    min_alternate_prob: float = 0.0  # alternate-token continuation threshold

    # sentence-length penalty (reference inference.py:59-68 intent)
    desired_sentence_length: int = 0  # 0 = off
    sentence_length_factor: float = 1.0

    # "fused" (default) | "fused_step" | "threshold" | "sort"; see the
    # module doc. vocab_prefilter > 0 runs "sort" on that many top
    # candidates (exact while the nucleus fits; 0 = full-vocabulary sorts).
    filter_method: str = "fused"
    vocab_prefilter: int = 0

    pad_token_id: int = 0


class StepRandomness:
    """The per-step randomness of a decode loop, drawn from one seed.

    Each step takes `step_seed()`, the 64-bit seed of the kernels' Philox
    generator (from a CPU generator: no device sync), and the threshold
    path draws its Gumbel noise from `generator` on the loop's device.
    generate and the serving chunk both draw through this, so a serve with
    no refill consumes the same stream as generate with the same seed.

    A data-parallel rank that runs rows [row_base, row_base + B) of a
    global batch of `global_rows` draws what the whole batch would: the
    kernels key Philox by the global row (row_base + row), and `gumbel`
    draws the global [global_rows, V] noise and keeps this rank's rows. So
    a sampled decode does not depend on the number of ranks."""

    def __init__(self, seed: int, device, row_base: int = 0,
                 global_rows: Optional[int] = None):
        self.generator = torch.Generator(device=device).manual_seed(int(seed))
        self._seeds = torch.Generator().manual_seed(int(seed))
        self.row_base = int(row_base)
        self.global_rows = global_rows

    def step_seed(self) -> int:
        return int(torch.randint(0, 2**62, (1,), generator=self._seeds))

    def gumbel(self, logits: torch.Tensor) -> torch.Tensor:
        """The threshold path's Gumbel noise for logits [B, V]: the rows of
        a draw over the global batch."""
        if self.global_rows is None:
            return S.gumbel_like(logits, self.generator)
        b, v = logits.shape
        full = S.gumbel_like(logits.new_empty((self.global_rows, v)), self.generator)
        return full[self.row_base: self.row_base + b]


def _check_filter_method(settings: GenerationSettings) -> None:
    if settings.filter_method not in ("fused", "fused_step", "threshold", "sort"):
        raise ValueError(f"unknown filter_method {settings.filter_method!r} (expected "
                         "'fused', 'fused_step', 'threshold' or 'sort')")


def uses_fused_filter(settings: GenerationSettings, logits: torch.Tensor) -> bool:
    """Whether filter_and_sample launches K2: "fused" on CUDA for a sampled
    step with no typical filter and no sentence-length penalty."""
    return (settings.filter_method == "fused" and not settings.greedy
            and not S.is_active(settings.typ_p)
            and not (settings.desired_sentence_length > 0 and settings.stop_token_id is not None)
            and logits.is_cuda)


def filter_and_sample(
    settings: GenerationSettings,
    logits: torch.Tensor,  # [B, V] f32, post rep-penalty / EOS suppression
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    typ_p: torch.Tensor,  # [B]
    step: int,
    *,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    gumbel_noise: Optional[torch.Tensor] = None,  # [B, V]
    row_base: int = 0,  # K2's Philox row of logits' row 0 (a data-parallel shard's first row)
):
    """Temperature -> filters -> sample: one step's logits pipeline.
    Returns (next_token, alt_token, alt_prob), each [B]."""
    _check_filter_method(settings)
    b = logits.shape[0]
    t = settings.temperature
    logits = logits / (t if t > 0 else 1.0)
    topk_active = S.is_active(settings.top_k)
    topp_active = S.is_active(settings.top_p)
    typp_active = S.is_active(settings.typ_p)
    slp_active = settings.desired_sentence_length > 0 and settings.stop_token_id is not None
    want_alt = (not settings.greedy) and settings.min_alternate_prob > 0
    if uses_fused_filter(settings, logits):
        return fused_filter_sample(logits, top_k, top_p, seed, do_topk=topk_active,
                                   do_topp=topp_active, want_alt_prob=want_alt,
                                   gumbel_noise=gumbel_noise, row_base=row_base)

    by_sort = settings.filter_method == "sort"
    if topk_active or topp_active:
        logits = (S.top_k_top_p_filter(logits, top_k, top_p, prefilter_k=settings.vocab_prefilter)
                  if by_sort else S.top_k_top_p_filter_threshold(logits, top_k, top_p))
    if typp_active:
        logits = (S.typical_filter(logits, typ_p) if by_sort
                  else S.typical_filter_threshold(logits, typ_p))
    if slp_active:
        logits = S.sentence_length_penalty(
            logits, settings.stop_token_id, current_length=step,
            desired_length=settings.desired_sentence_length,
            length_factor=settings.sentence_length_factor)

    if settings.greedy:
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, next_token, torch.zeros(b, device=logits.device)
    samples = S.sample_categorical(logits, 2, gumbel=gumbel_noise, generator=generator)
    next_token, alt_token = samples[:, 0], samples[:, 1]
    if want_alt:
        probs = torch.softmax(logits, dim=-1)
        alt_prob = torch.gather(probs, 1, alt_token[:, None].long())[:, 0]
    else:
        alt_prob = torch.zeros(b, device=logits.device)
    return next_token, alt_token, alt_prob


def uses_fused_step(settings: GenerationSettings, device) -> bool:
    """Whether the sampled step runs K3: "fused_step" on CUDA, wherever the
    fused sampler itself applies and penalty and temperature are scalars
    (the JAX engine's rule, engine.py:288-299)."""
    pen = settings.repetition_penalty
    pen = 1.0 if pen in (None, 0.0) else pen
    return (settings.filter_method == "fused_step"
            and not settings.greedy
            and not S.is_active(settings.typ_p)
            and not (settings.desired_sentence_length > 0 and settings.stop_token_id is not None)
            and isinstance(pen, (int, float))
            and isinstance(settings.temperature, (int, float))
            and torch.device(device).type == "cuda")


def sample_step(
    settings: GenerationSettings,
    logits: torch.Tensor,  # [B, V] f32 raw step logits
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    typ_p: torch.Tensor,
    rand: StepRandomness,
    *,
    use_fused_step: bool,
    counter,  # int step, or [B] steps since each row's start (min-length gate)
    min_len: torch.Tensor,  # [B]
    hist: torch.Tensor,  # [B, H] token history (repetition penalty)
    hist_valid: torch.Tensor,  # [B, H] bool
    step: int = 0,  # sentence-length penalty input
    gumbel_noise: Optional[torch.Tensor] = None,  # [B, V]
):
    """One step's pre-filter pipeline and sampler, shared by generate and
    the serving chunk: raw log P(eos), min-length eos suppression where
    counter < min_len, repetition penalty, then filter_and_sample (K2 on
    CUDA) or, for use_fused_step, all of it in K3. Draws the step's
    randomness from `rand`. Returns (next [B] i64, alt [B] i64,
    alt_prob [B], raw eos logprob [B] or None)."""
    eos = settings.eos_token_id
    step_seed = rand.step_seed()
    if (gumbel_noise is None and rand.global_rows is not None and not settings.greedy
            and not use_fused_step and not uses_fused_filter(settings, logits)):
        gumbel_noise = rand.gumbel(logits)  # the threshold path's global rows
    if use_fused_step:
        pen = settings.repetition_penalty
        pen = 1.0 if pen in (None, 0.0) else float(pen)
        appears = (S.token_occurrence_mask(hist, logits.shape[1], hist_valid)
                   if pen != 1.0 else None)
        t = settings.temperature
        next_token, alt_token, alt_prob, raw_eos_lp = fused_step_sample(
            logits, top_k, top_p, step_seed, appears=appears, penalty=pen,
            temperature=float(t if t > 0 else 1.0), eos_token_id=eos,
            suppress_eos=(counter < min_len) if eos is not None else None,
            want_eos_lp=eos is not None, do_topk=S.is_active(settings.top_k),
            do_topp=S.is_active(settings.top_p),
            want_alt_prob=(not settings.greedy) and settings.min_alternate_prob > 0,
            gumbel_noise=gumbel_noise, row_base=rand.row_base)
    else:
        raw_eos_lp = None
        if eos is not None:
            # raw (pre-filter) log P(eos), then min-length suppression
            # (reference sampling.py:205-206, :228-235)
            raw_eos_lp = logits[:, eos] - torch.logsumexp(logits, dim=-1)
            logits = logits.clone()
            logits[:, eos] = torch.where(counter < min_len, float("-inf"), logits[:, eos])
        if settings.repetition_penalty not in (None, 0.0, 1.0):
            logits = S.repetition_penalty(logits, hist, settings.repetition_penalty,
                                          tokens_valid=hist_valid)
        next_token, alt_token, alt_prob = filter_and_sample(
            settings, logits, top_k, top_p, typ_p, step, seed=step_seed,
            generator=rand.generator, gumbel_noise=gumbel_noise, row_base=rand.row_base)
    return next_token.to(torch.int64), alt_token.to(torch.int64), alt_prob, raw_eos_lp


def complete_step(settings: GenerationSettings, next_token, alt_token, alt_prob, raw_eos_lp, *,
                  counter, max_len: torch.Tensor, stops: torch.Tensor):
    """The engine's completion logic for one step, shared by generate and
    the serving chunk; `counter` is the step (an int, or each row's [B]
    steps since its start). Returns (next_token after the alternate-token
    continuation, completed, over_length, stops), each [B]."""
    eos = settings.eos_token_id
    completed = torch.zeros(next_token.shape, dtype=torch.bool, device=next_token.device)
    over_length = torch.zeros_like(completed)
    if eos is not None:
        completed |= next_token == eos
        # the reference splices length-capped rows out BEFORE appending
        # the sampled token (sampling.py:252-268): this step's token is
        # suppressed, not emitted
        over_length = max_len <= counter
        completed |= over_length
        if settings.force_eos_log_prob < 0:
            force_eos = raw_eos_lp > settings.force_eos_log_prob
            completed |= force_eos
            over_length = over_length | force_eos
        # alternate-token continuation (reference sampling.py:240-250)
        if settings.min_alternate_prob > 0 and not settings.greedy:
            cont = (completed & (max_len > counter) & (alt_token != eos)
                    & (alt_prob > settings.min_alternate_prob))
            next_token = torch.where(cont, alt_token, next_token)
            completed = completed & ~cont
    if settings.stop_token_id is not None:
        stops = stops + (next_token == settings.stop_token_id).to(stops.dtype)
        completed |= stops >= settings.max_stops
    for sid in settings.stop_on_special:
        completed |= next_token == sid
    return next_token, completed, over_length, stops


@torch.no_grad()
def generate(
    lm,  # LM module implementing the lm/registry protocol
    prompt_embeds: torch.Tensor,  # [B, P, D] embeddings, or [B, P] token ids
    settings: GenerationSettings,
    *,
    seed: int = 0,
    gumbel_noise: Optional[torch.Tensor] = None,  # [N, B, V] per-step draws
    prompt_tokens: Optional[torch.Tensor] = None,  # [B, Tp] fed to rep-penalty
    device="cuda",
    cache_constraint=None,  # cache -> cache; e.g. dp.DPDecodeShardings.constrain_cache
) -> dict:
    """Generate settings.max_new_tokens tokens after prompt_embeds, on
    `device` (the card unless asked for the CPU; the LM and the prompt
    must already lie there).

    When `lm.takes_token_ids` is set (the BLIP decoder adapter, whose
    embedding layer owns positions and LayerNorm), `prompt_embeds` is a
    [B, P] int tensor of token ids, each step feeds the emitted ids, and
    the adapter picks its own cache dtype (JAX engine.py:240-251, :271-273,
    :409-414).

    Returns a dict with tokens [B, N] int32 (pad_token_id after a row
    stops), lengths [B] (generated tokens incl. the stopping token),
    stopped [B] bool and, iff eos_token_id is set, eos_logprob [B, N]
    (raw log P(eos) per step).

    `cache_constraint` is the multi-card hook: applied once to the fresh
    cache, as in JAX. Under data parallelism (a dp.DPDecodeShardings'
    constrain_cache) every rank is given the whole batch, decodes its rows
    [lo, hi) of it (its cache keeps those rows, its sampler draws global
    rows lo.. of the randomness) and all-gathers the result over `data`,
    so each rank returns what one process would."""
    from ..parallel.dp import layout_of

    _check_filter_method(settings)
    dev = torch.device(device)
    if prompt_embeds.device.type != dev.type:
        raise ValueError(f"prompt on {prompt_embeds.device}, generate asked for {dev}")
    b, p_len = prompt_embeds.shape[:2]
    n = settings.max_new_tokens
    dev = prompt_embeds.device
    eos = settings.eos_token_id

    top_k = S.per_row(settings.top_k, b, dev)
    top_p = S.per_row(settings.top_p, b, dev)
    typ_p = S.per_row(settings.typ_p, b, dev)
    min_len = S.per_row(settings.min_length, b, dev, torch.int64)
    max_len = S.per_row(settings.max_length, b, dev, torch.int64)
    if gumbel_noise is not None:
        gumbel_noise = gumbel_noise.to(device=dev, dtype=torch.float32)

    dp = layout_of(cache_constraint)
    b_global = b
    if dp is not None:
        lo, hi = dp.rows(b)
        prompt_embeds, top_k, top_p, typ_p, min_len, max_len = (
            x[lo:hi] for x in (prompt_embeds, top_k, top_p, typ_p, min_len, max_len))
        if prompt_tokens is not None:
            prompt_tokens = prompt_tokens[lo:hi]
        if gumbel_noise is not None:
            gumbel_noise = gumbel_noise[:, lo:hi]
        b = hi - lo
        rand = StepRandomness(seed, dev, row_base=lo, global_rows=b_global)
    else:
        rand = StepRandomness(seed, dev)

    n_prompt_tok = 0 if prompt_tokens is None else prompt_tokens.shape[1]
    hist = torch.zeros((b, n_prompt_tok + n), dtype=torch.int64, device=dev)
    hist_valid = torch.zeros((b, n_prompt_tok + n), dtype=torch.bool, device=dev)
    if prompt_tokens is not None:
        hist[:, :n_prompt_tok] = prompt_tokens.to(dev)
        hist_valid[:, :n_prompt_tok] = True

    token_mode = bool(getattr(lm, "takes_token_ids", False))
    cache = lm.init_cache(b_global, p_len + n, dtype=None if token_mode else prompt_embeds.dtype)
    if cache_constraint is not None:
        cache = cache_constraint(cache)
    prefill_logits, cache = lm.prefill(prompt_embeds, cache)
    last_logits = prefill_logits[:, -1].float()

    use_fused_step = uses_fused_step(settings, dev)
    stopped = torch.zeros(b, dtype=torch.bool, device=dev)
    stops = torch.zeros(b, dtype=torch.int64, device=dev)
    tok_steps, live_steps, eos_steps = [], [], []
    for step in range(n):
        next_token, alt_token, alt_prob, raw_eos_lp = sample_step(
            settings, last_logits, top_k, top_p, typ_p, rand, use_fused_step=use_fused_step,
            counter=step, min_len=min_len, hist=hist, hist_valid=hist_valid, step=step,
            gumbel_noise=None if gumbel_noise is None else gumbel_noise[step])
        next_token, completed, over_length, stops = complete_step(
            settings, next_token, alt_token, alt_prob, raw_eos_lp, counter=step,
            max_len=max_len, stops=stops)
        eos_lp = raw_eos_lp if eos is not None else torch.zeros(b, device=dev)

        suppress = stopped | over_length
        emitted = torch.where(suppress, settings.pad_token_id, next_token)
        hist[:, n_prompt_tok + step] = emitted
        hist_valid[:, n_prompt_tok + step] = ~suppress
        stopped = stopped | completed
        tok_steps.append(emitted)
        live_steps.append(~suppress)
        eos_steps.append(eos_lp)

        if step + 1 < n:  # the last step's logits would go unused
            step_in = (emitted[:, None] if token_mode
                       else lm.embed_tokens(emitted)[:, None, :].to(prompt_embeds.dtype))
            logits_next, cache = lm.decode_step(step_in, cache)
            last_logits = logits_next.float()

    live = torch.stack(live_steps, dim=1)
    result = {
        "tokens": torch.stack(tok_steps, dim=1).to(torch.int32),
        "lengths": live.sum(dim=-1).to(torch.int32),
        "stopped": stopped,
    }
    if eos is not None:
        result["eos_logprob"] = torch.stack(eos_steps, dim=1)
    if dp is not None:
        result = {k: dp.gather(v) for k, v in result.items()}
    return result


def trim_and_decode(result: dict, tokenizer, strip_special: bool = True,
                    skip_ids: Sequence[int] = ()) -> list:
    """Host side: a generate() result -> caption strings. Tokens after the
    stop are dropped and special tokens stripped when requested (reference
    evaluate_model.py:174)."""
    tokens = result["tokens"].cpu().tolist()
    lengths = result["lengths"].cpu().tolist()
    special = set(getattr(tokenizer, "all_special_ids", ())) if strip_special else set()
    special |= set(skip_ids)
    return [tokenizer.decode_tokens([t for t in row[:ln] if t not in special])
            for row, ln in zip(tokens, lengths)]
