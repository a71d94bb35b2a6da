"""Continuous-batching serving engine (port of clipcap_tpu/decode/serving.py).

The static engine (decode/engine.py) runs every batch for the full
`max_new_tokens`: rows that stop early are masked but still pay every
remaining step, and a new request waits for the whole batch. This engine
keeps a fixed batch of B *slots* busy and refills a slot with the next
queued request once its occupant finishes, so throughput follows the mean
output length instead of the maximum.

Design, as in the JAX engine:

- The KV cache's time axis is a RING of prompt_len + lifetime + 1 positions
  shared by all slots at one global write index (models/gpt2.py
  decode_step_ring); each slot attends only its own request's window
  through the [B, T] bias of ops/ring.py.
- Refills prefill the new requests into a small [R, P] cache and paste the
  R rows into a CONTIGUOUS block of slots (GPT2.scatter_refill). Slots
  retire FIFO: a slot that finishes early waits, stopped, until the retire
  pointer reaches it. Refill sizes come from a small ladder; a queue-tail
  batch pads up with dead rows, and batches below `min_refill` wait a chunk
  for a bigger block.
- The host harvests once per chunk of `steps_per_sync` decode steps. The
  loop keeps up to `pipeline_depth` chunks in flight: chunk k's outputs
  are copied without blocking into pinned host memory and a CUDA event is
  recorded behind the copy, both before chunk k+1 is issued, so the
  harvest of chunk k waits for chunk k only. Slots are retired eagerly
  once their length cap guarantees they have stopped; per-slot
  generation counters keep a late harvest from being read as the new
  occupant's.

Sampling is the static engine's per step (decode/engine.sample_step and
complete_step) with each slot's own counters: `age` (decode steps since
its refill) for the min-length gate, the length caps and the scan bound.
On CUDA, filter_method="fused" launches K2 and "fused_step" launches K3
once per decode step. Nothing in a chunk reads a device value on the host,
so the launch stream never stalls inside a chunk.

On CUDA, an LM that declares `graph_safe_ring_step` (GPT2Int8: its ring
step takes the ring index as a device tensor) has the LM part of a step
(the embedding, the ring step and the logits' cast) captured once as a
CUDA graph over static buffers and the engine's own ring cache, and
replayed at every decode step: the same kernels on the same data, issued
by one launch instead of one per operation. The engine keeps that cache
for its lifetime (zeroed and prefilled by each serve), so the graph's
pointers stay valid; the sampler, the bookkeeping and the refills stay
eager. `stats["graph_steps"]` counts the replayed steps.

Left behind as TPU workarounds: layout pinning, the jitted row gather and
buffer donation. The sentence-length penalty is rejected (it needs the
batch-global step counter). Supported LMs: any module with
`decode_step_ring` and `scatter_refill` (GPT-2, GPT-J and T5, float and
int8; a T5 refill swaps each request's encoder output in by a row paste),
and the BLIP decoder through blip_text.serving_decoder_lm. That adapter
takes token ids (`takes_token_ids`): each step feeds the emitted ids, a
request's prefix is its image features [Tv, W], whose prefill makes its
cross-attention K/V, and a fixed decoder prompt occupies the ring. Pass
prefix_len = image tokens and prompt_len = prompt ids.

Data parallelism (`cache_constraint` = a dp.DPDecodeShardings'
constrain_cache), as JAX's one global scheduler over sharded slots: the
host scheduler (admission, the refill ladder, retirement, the pending
map) runs on every rank alike, over all `slots`. Each rank holds the ring
cache and the device state of its slot range [r*S/n, (r+1)*S/n), samples
its rows as global rows r*S/n.. of the randomness, and runs the part of
each refill block that falls in its range. Each chunk's outputs are
all-gathered over `data` before the harvest, so every rank reads every
slot and makes the same decisions: the result is the one-process serve's,
request for request.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional

import numpy as np
import torch

from ..ops import sampling as S
from ..ops.ring import paste_rows_axis0
from ..utils import profiling as P
from .engine import (BIG, GenerationSettings, StepRandomness, _check_filter_method,
                     complete_step, sample_step, uses_fused_step)


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: a prefix (mapper output) and an optional cap.

    `prefix_embeds` is a [P, D] host array, or, when `serve()` is given a
    `prefix_pool`, an int row index into that device-resident pool.
    `arrival_ns`, on time.perf_counter_ns, stamps when the request arrived:
    with a tracer active, its wait until the engine pulls it is recorded."""

    request_id: Any
    prefix_embeds: Any
    max_length: Optional[int] = None  # per-request new-token cap
    arrival_ns: Optional[int] = None


@dataclasses.dataclass
class ServingState:
    """The slots' device state. Tensors are [B] unless noted; the cache is
    written in place and its index is the global step counter."""

    cache: Any
    last_logits: torch.Tensor  # [B, V] f32
    start: torch.Tensor  # global timestep of each row's window start
    pos: torch.Tensor  # logical position of the NEXT fed token
    gen_count: torch.Tensor  # tokens emitted for the current request
    age: torch.Tensor  # decode steps since refill (the engine's step counter)
    hist: torch.Tensor  # [B, N] emitted-token history (repetition penalty)
    hist_valid: torch.Tensor  # [B, N] bool
    stopped: torch.Tensor  # bool, includes the max_new_tokens bound
    nat_stopped: torch.Tensor  # bool, completed naturally (the engine's `stopped`)
    stops: torch.Tensor  # stop-token count
    live: torch.Tensor  # bool, slot holds an unfinished request
    max_len: torch.Tensor  # per-request new-token cap
    rand: StepRandomness


class ServingEngine:
    """Slot-based continuous batching over a ring KV cache.

    Build once per (lm, settings, slot geometry); `serve()` any number of
    request streams. The LM and every tensor live on `device`, the card
    unless the caller asks for the CPU."""

    def __init__(
        self,
        lm: Any,
        lm_cfg: Any,
        prefix_len: int,
        settings: GenerationSettings,
        prompt_len: Optional[int] = None,
        slots: int = 256,
        refill_size: Optional[int] = None,
        steps_per_sync: int = 8,
        dtype: Optional[torch.dtype] = None,
        refill_sizes=None,
        min_refill: Optional[int] = None,
        pipeline_depth: int = 2,
        max_request_length: Optional[int] = None,
        chunk_sizes=None,
        device="cuda",
        cache_constraint=None,  # cache -> cache, applied once to the fresh ring cache
    ):
        if not hasattr(lm, "decode_step_ring") or not hasattr(lm, "scatter_refill"):
            raise TypeError(f"LM module {lm!r} does not support ring decode "
                            "(needs decode_step_ring + scatter_refill; see models/gpt2.py)")
        if settings.desired_sentence_length > 0:
            raise ValueError("the sentence-length penalty needs the batch-global step counter "
                             "and is not available under continuous batching")
        for name in ("top_k", "top_p", "typ_p", "min_length"):
            if np.ndim(getattr(settings, name)) != 0:
                raise ValueError(
                    f"per-row {name} vectors are batch-positional and do not survive slot "
                    "refills; ServingEngine takes scalars (use per-request max_length on "
                    "Request for length caps)")
        _check_filter_method(settings)
        # token-id adapters (blip_text.serving_decoder_lm) are fed ids; their
        # prefix is still a tensor per request (the image features)
        self.token_mode = bool(getattr(lm, "takes_token_ids", False))
        self.device = torch.device(device)
        weights = next(lm.parameters())
        if weights.device.type != self.device.type:
            raise ValueError(f"LM on {weights.device}, serving asked for {self.device}")
        self.lm = lm
        self.cfg = lm_cfg
        self.settings = settings
        self.prefix_len = int(prefix_len)
        self.prompt_len = int(prompt_len if prompt_len is not None else prefix_len)
        self.slots = int(slots)
        self.refill_size = int(refill_size or max(1, slots // 8))
        self.steps_per_sync = int(steps_per_sync)
        self.pipeline_depth = max(1, int(pipeline_depth))
        # a token-id adapter names its own cache dtype (f32 for BLIP, as JAX's)
        self.dtype = dtype or getattr(lm, "cache_dtype", None) or weights.dtype
        # ring capacity: a row refilled at index I0 claims [I0-P, I0-1] and
        # its step k reads P+k entries, so T >= P + lifetime + 1. The
        # lifetime is the scan bound n or, when the caller DECLARES every
        # request's cap <= max_request_length, min(cap+1, n): every decode
        # step reads the whole ring, so a declared cap shortens each step.
        n = settings.max_new_tokens
        self.max_request_length = None if max_request_length is None else int(max_request_length)
        if (self.max_request_length is not None and self.max_request_length < n
                and settings.eos_token_id is None):
            # caps bind through the engine's completion logic, which runs
            # only with eos handling on; without it rows outlive the ring
            raise ValueError("max_request_length < max_new_tokens requires "
                             "settings.eos_token_id (length caps bind through the "
                             "engine's eos/completion logic)")
        lifetime = n if self.max_request_length is None else min(n, self.max_request_length + 1)
        self.ring_len = self.prompt_len + lifetime + 1

        # opt-in ladder of chunk lengths: serve() dispatches the largest
        # one that does not cross the next block's guaranteed retirement.
        # The default is one fixed steps_per_sync chunk.
        if chunk_sizes is not None:
            self._chunk_sizes = sorted({int(k) for k in chunk_sizes}, reverse=True)
            if self._chunk_sizes[0] > self.steps_per_sync:
                raise ValueError("chunk sizes cannot exceed steps_per_sync")
        else:
            self._chunk_sizes = [self.steps_per_sync]
        self.stats = None  # the serve call's counters, updated in place while it runs
        self.last_stats = None
        # refill sizes (default powers of two up to refill_size); padding
        # rows land dead, so one size serves any batch up to it. The
        # ladder must hold 1 so a single free slot can always be filled.
        if refill_sizes is not None:
            self._refill_sizes = sorted(int(k) for k in refill_sizes)
            if not self._refill_sizes or self._refill_sizes[0] != 1:
                raise ValueError("refill_sizes must include 1")
            if self._refill_sizes[-1] > self.slots:
                raise ValueError("refill sizes cannot exceed the slot count")
        else:
            self._refill_sizes = []
            k = 1
            while k <= self.refill_size:
                self._refill_sizes.append(k)
                k *= 2
        # below this many retirable requests, wait a chunk for a bigger
        # block: every refill pays a prefill of its own
        self.min_refill = int(min_refill) if min_refill is not None else max(
            1, min(self._refill_sizes[-1] // 4, self.slots))

        from ..parallel.dp import layout_of

        self.cache_constraint = cache_constraint
        self._dp = layout_of(cache_constraint)
        # this rank's slot range (all slots without data parallelism)
        self._lo, self._hi = (0, self.slots) if self._dp is None else self._dp.rows(self.slots)
        b, dev = self._hi - self._lo, self.device
        self._top_k = S.per_row(settings.top_k, b, dev)
        self._top_p = S.per_row(settings.top_p, b, dev)
        self._typ_p = S.per_row(settings.typ_p, b, dev)
        self._min_len = S.per_row(settings.min_length, b, dev, torch.int64)
        self._use_fused_step = uses_fused_step(settings, dev)
        # dead slots keep stepping until refilled: clamp their position
        # inside the position table of an absolute-position model (T5's
        # relative positions have no table, and no clamp)
        limit = getattr(lm_cfg, "n_positions", None) or getattr(lm_cfg,
                                                                 "max_position_embeddings", None)
        self._pos_limit = None if limit is None else int(limit)
        self._graphable = (self.device.type == "cuda"
                           and bool(getattr(lm, "graph_safe_ring_step", False)))
        self._graph: Optional[_GraphStep] = None  # captured by the first _init

    # ---- device steps ---------------------------------------------------------

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On CUDA the copy goes
        through pinned memory without blocking: a pageable copy would wait
        for every chunk in flight."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _fresh_cache(self):
        cache = self.lm.init_cache(self.slots, self.ring_len, dtype=self.dtype)
        return cache if self.cache_constraint is None else self.cache_constraint(cache)

    @torch.no_grad()
    def _init(self, prefixes: torch.Tensor, live: torch.Tensor, max_len: torch.Tensor,
              seed: int) -> ServingState:
        """Prefill the first B requests (all slots' rows; this rank keeps
        its range) into a fresh ring cache: a new one, or with the graph
        step the engine's own, zeroed (the first call captures the step)."""
        n, dev = self.settings.max_new_tokens, self.device
        if not self._graphable:
            cache = self._fresh_cache()
        else:
            if self._graph is None:
                with P.span("serving.graph_capture"):
                    self._graph = _GraphStep(self, self._fresh_cache())
            cache = self._graph.cache
            for t in cache:
                if isinstance(t, torch.Tensor):
                    t.zero_()
        lo, hi = self._lo, self._hi
        prefixes, live, max_len = prefixes[lo:hi], live[lo:hi], max_len[lo:hi]
        b = hi - lo
        rand = (StepRandomness(seed, dev) if self._dp is None
                else StepRandomness(seed, dev, row_base=lo, global_rows=self.slots))
        logits, cache = self.lm.prefill(prefixes, cache)
        last_logits = logits[:, -1].float()
        if self._graph is not None:  # the graph writes each step's logits there
            last_logits = self._graph.logits.copy_(last_logits)

        def zeros(*shape, dtype=torch.int64):  # one tensor each: refills write in place
            return torch.zeros(shape, dtype=dtype, device=dev)

        return ServingState(
            cache=cache, last_logits=last_logits, start=zeros(b),
            pos=torch.full((b,), self.prompt_len, dtype=torch.int64, device=dev),
            gen_count=zeros(b), age=zeros(b), hist=zeros(b, n),
            hist_valid=zeros(b, n, dtype=torch.bool), stopped=~live,
            nat_stopped=zeros(b, dtype=torch.bool), stops=zeros(b), live=live,
            max_len=max_len, rand=rand)

    @torch.no_grad()
    def _chunk(self, st: ServingState, n_steps: int) -> torch.Tensor:
        """n_steps decode steps with generate's semantics per slot, updating
        `st`. Returns [n_steps + 2, B] int32 over all slots (this rank's,
        all-gathered over `data` under data parallelism): each step's
        emitted token (-1 where nothing was emitted), then stopped and
        nat_stopped.

        With a tracer active, each step is tiled by the call-stack spans
        `serving.step.sample` (sample_step and complete_step),
        `serving.step.book` (the slots' bookkeeping) and `serving.step.lm`
        (the embedding, the ring step and its logits' cast, or the graph
        step's copy-in and replay)."""
        settings = self.settings
        n = settings.max_new_tokens
        out = []
        tr = P.active()
        for _ in range(n_steps):
            if tr is not None:
                t0 = P.now_ns()
            next_token, alt_token, alt_prob, raw_eos_lp = sample_step(
                settings, st.last_logits, self._top_k, self._top_p, self._typ_p, st.rand,
                use_fused_step=self._use_fused_step, counter=st.age, min_len=self._min_len,
                hist=st.hist, hist_valid=st.hist_valid)
            # completion with the engine's step counter read as each slot's age
            next_token, completed, over_length, st.stops = complete_step(
                settings, next_token, alt_token, alt_prob, raw_eos_lp, counter=st.age,
                max_len=st.max_len, stops=st.stops)
            if tr is not None:
                t1 = P.now_ns()
                tr.add("serving.step.sample", t0, t1)
            suppress = st.stopped | ~st.live | over_length
            emitted = torch.where(suppress, settings.pad_token_id, next_token)
            emit_valid = ~suppress
            hpos = st.gen_count.clamp(max=n - 1)[:, None]
            st.hist.scatter_(1, hpos, torch.where(emit_valid[:, None], emitted[:, None],
                                                  st.hist.gather(1, hpos)))
            st.hist_valid.scatter_(1, hpos, st.hist_valid.gather(1, hpos) | emit_valid[:, None])
            st.gen_count = st.gen_count + emit_valid
            # the lifetime bound is the engine's scan length, n steps, not n
            # emitted tokens: an alternate-token rescue of a force-eos stop
            # runs on without emitting and must not outlive its ring window
            st.age = st.age + (st.live & ~st.stopped)
            st.nat_stopped = st.nat_stopped | (completed & ~st.stopped)
            st.stopped = st.stopped | completed | (st.age >= n)
            out.append(torch.where(emit_valid, emitted, -1))
            pos = st.pos + 1 if self._pos_limit is None else (st.pos + 1).clamp(
                max=self._pos_limit - 1)
            if tr is not None:
                t2 = P.now_ns()
                tr.add("serving.step.book", t1, t2)
            if self._graph is not None:
                st.cache = self._graph.replay(emitted, st.cache, st.pos, st.start)
            else:
                st.last_logits, st.cache = self._lm_step(emitted, st.cache, st.pos, st.start)
            if tr is not None:
                tr.add("serving.step.lm", t2, P.now_ns())
            st.pos = pos
        out += [st.stopped.long(), st.nat_stopped.long()]
        packed = torch.stack(out).to(torch.int32)
        return packed if self._dp is None else self._dp.gather(packed, axis=1)

    def _lm_step(self, tokens: torch.Tensor, cache, pos: torch.Tensor, start: torch.Tensor,
                 index: Optional[torch.Tensor] = None):
        """The LM part of a decode step: the emitted tokens [B] embedded (fed
        as ids to a token-id adapter), the ring step, and its logits in f32.
        `index` is the graph step's device ring index."""
        step_in = (tokens[:, None] if self.token_mode
                   else self.lm.embed_tokens(tokens)[:, None, :].to(self.dtype))
        kw = {} if index is None else {"index": index}
        logits, cache = self.lm.decode_step_ring(step_in, cache, pos, start, **kw)
        return logits.float(), cache

    @torch.no_grad()
    def _refill(self, r: int, st: ServingState, prefixes: torch.Tensor, q: int,
                new_max_len: torch.Tensor, n_real: int) -> None:
        """Prefill r new requests into the CONTIGUOUS slot block [q, q+r).
        The first n_real rows are requests; the rest are padding that lands
        dead (live False, stopped True) and emits nothing. A rank runs the
        part of the block in its slot range, if any."""
        a, z = max(q, self._lo), min(q + r, self._hi)
        if a >= z:
            return
        real = torch.arange(r, device=self.device) < n_real
        prefixes, new_max_len, real = (x[a - q: z - q] for x in (prefixes, new_max_len, real))
        q, r = a - self._lo, z - a
        small = self.lm.init_cache(r, self.prompt_len, dtype=self.dtype)
        logits, small = self.lm.prefill(prefixes, small)
        st.cache = self.lm.scatter_refill(st.cache, small, q)
        block = slice(q, q + r)
        for vec in (st.gen_count, st.age, st.hist, st.hist_valid, st.nat_stopped, st.stops):
            vec[block] = 0
        st.start[block] = st.cache.index - self.prompt_len
        st.pos[block] = self.prompt_len
        paste_rows_axis0(st.last_logits, logits[:, -1].float(), q)
        paste_rows_axis0(st.stopped, ~real, q)
        paste_rows_axis0(st.live, real, q)
        paste_rows_axis0(st.max_len, new_max_len, q)

    def _harvestable(self, packed: torch.Tensor):
        """Start the chunk output's copy to the host: on CUDA a pinned
        buffer filled without blocking and an event recorded behind it."""
        if self.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    # ---- host loop ------------------------------------------------------------

    @P.traced("serving.warmup")
    def warmup(self, embed_dim: Optional[int] = None) -> "ServingEngine":
        """Run init, every chunk length and every refill size once on dummy
        data: the card's libraries, the kernels' build and the allocator
        are then ready before the first request stream. The dummy prefix
        rows are `embed_dim` wide: the LM's embedding width, or a token-id
        adapter's prefix width (BLIP: the image encoder's)."""
        embed_dim = embed_dim or (self.lm.prefix_width() if self.token_mode
                                  else self.lm.embedding_size())
        b, dev = self.slots, self.device
        zeros = torch.zeros((b, self.prefix_len, embed_dim), dtype=self.dtype, device=dev)
        caps = torch.full((b,), self.settings.max_new_tokens, dtype=torch.int64, device=dev)
        st = self._init(zeros, torch.ones(b, dtype=torch.bool, device=dev), caps, 0)
        for k in self._chunk_sizes:
            self._chunk(st, k)
        for r in self._refill_sizes:
            self._refill(r, st, zeros[:r], 0, caps[:r], r)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return self

    @P.traced("serving.serve")
    def serve(self, requests: Iterable[Request], seed: int = 0, prefix_pool=None,
              on_result=None, admission: str = "fifo",
              admission_lookahead: Optional[int] = None) -> dict:
        """Run every request to completion; returns {request_id: result}.

        result = {"tokens": [int], "length": int, "stopped": bool,
        "latency_s": float} with generate's token semantics (the stopping
        token is included; suppressed over-length tokens are not; `stopped`
        means the request completed naturally rather than at the
        max_new_tokens bound). latency_s is the time from slot assignment
        (the dispatch of the request's refill) to the result, on
        time.perf_counter; the harvest trails the device by up to
        `pipeline_depth` chunks, so compare latencies at one depth.
        `self.stats` holds the call's counters, updated in place as it runs;
        `last_stats` the last finished call's.

        `seed` seeds the step randomness as generate's `seed` does: with no
        refill a serve draws what generate draws. `prefix_pool`: an optional
        [n, P, D] tensor on the engine's device; each request's
        prefix_embeds is then a row index. `on_result(request_id, result)`
        fires as each request is harvested. `requests` may be a lazy
        iterator: it is consumed in order and only as slots free up.

        `admission`: "fifo" assigns requests in arrival order; "length"
        sorts the look-ahead window by effective cap, so a refill block
        holds near-equal caps and retires together. Greedy streams are the
        same under either, and under any pipeline_depth; sampled streams
        draw other steps' randomness once refills occur.

        Slots retire EAGERLY: a slot is guaranteed stopped once
        min(cap, max_new_tokens - 1) + 1 decode steps were dispatched after
        its refill, so it is refilled without waiting for its harvest; its
        tokens still in flight drain into the `pending` map. Natural stops
        earlier than the cap retire at harvest.

        With a tracer active (utils/profiling.py), the call records the
        call-stack spans `serving.chunk` (a chunk's dispatch with its queued
        copy to the host), `serving.refill` (with its block size `r` and
        `n_real` requests), `serving.harvest_wait`, and per request the
        intervals `serving.request.queued` (from `arrival_ns`, when given,
        to the pull from `requests`), `.admit` (to its slot assignment),
        `.decode` (to the end of the dispatch of the chunk that carries its
        stop) and `.harvest` (to its result)."""
        settings = self.settings
        tr = P.active()
        pulled = {}  # id(request) -> when it was pulled, while tracing
        b, dev = self.slots, self.device
        req_iter = iter(requests)
        buffered: list = []  # look-ahead pulled from req_iter
        if admission not in ("fifo", "length"):
            raise ValueError(f"unknown admission policy {admission!r}")
        lookahead = int(admission_lookahead) if admission_lookahead else (
            2 * b if admission == "length" else 0)
        arrival = [0]  # stable tiebreak for the length sort

        def pull(n: int) -> int:
            """Buffer up to n requests (at least the look-ahead); returns
            len(buffered). Under "length" the buffer stays sorted by cap."""
            n = max(n, lookahead)
            grew = False
            while len(buffered) < n:
                try:
                    req = next(req_iter)
                except StopIteration:
                    break
                if tr is not None:
                    t = pulled[id(req)] = P.now_ns()
                    if req.arrival_ns is not None:
                        tr.interval("serving.request.queued", req.arrival_ns, t,
                                    request_id=req.request_id)
                buffered.append((arrival[0], req))
                arrival[0] += 1
                grew = True
            if grew and admission == "length":
                buffered.sort(key=lambda ar: (eff_cap(ar[1]), ar[0]))
            return len(buffered)

        def pop_next() -> Request:
            return buffered.pop(0)[1]

        if prefix_pool is not None:
            pool = torch.as_tensor(prefix_pool).to(device=dev, dtype=self.dtype)

            def stack_prefixes(reqs, pad_to):
                ix = [int(r.prefix_embeds) if r is not None else 0 for r in reqs]
                ix += [0] * (pad_to - len(ix))
                return pool.index_select(0, self._to_device(np.asarray(ix, np.int64)))
        else:
            def stack_prefixes(reqs, pad_to):
                d = next(np.asarray(r.prefix_embeds).shape[-1] for r in reqs if r is not None)
                zeros = np.zeros((self.prefix_len, d), np.float32)
                rows = [np.asarray(r.prefix_embeds, np.float32) if r is not None else zeros
                        for r in reqs]
                rows += [zeros] * (pad_to - len(rows))
                return self._to_device(np.stack(rows)).to(self.dtype)

        default_cap = settings.max_length
        if not isinstance(default_cap, (int, np.integer)):
            default_cap = BIG

        def req_cap(req):
            cap = req.max_length if req.max_length is not None else default_cap
            if (self.max_request_length is not None
                    and min(cap, settings.max_new_tokens) > self.max_request_length):
                raise ValueError(
                    f"request {req.request_id!r} has effective cap {cap} > the engine's "
                    f"declared max_request_length {self.max_request_length} (its ring is "
                    "sized for the declaration; route longer requests to an engine "
                    "without one)")
            return cap

        n_steps_cap = settings.max_new_tokens

        def eff_cap(req):
            """Decode steps after which the slot is guaranteed stopped: the
            step entering at age == cap flips `stopped`."""
            return min(req_cap(req), n_steps_cap - 1) + 1

        # ---- initial fill
        pull(b)
        first = [pop_next() if buffered else None for _ in range(b)]
        if all(req is None for req in first):
            return {}
        live = np.array([req is not None for req in first])
        caps = np.array([req_cap(req) if req is not None else 0 for req in first], np.int64)
        state = self._init(stack_prefixes(first, b), self._to_device(live),
                           self._to_device(caps), seed)
        now = P.now_ns()
        if tr is not None:
            for req in first:
                if req is not None:
                    tr.interval("serving.request.admit", pulled.pop(id(req)), now,
                                request_id=req.request_id)

        slot_req = list(first)  # each slot's current Request (None = free)
        harvested = [False] * b  # result recorded; the slot awaits FIFO retirement
        # per-slot refill generation: a chunk's outputs are read against the
        # generation active when it was DISPATCHED, so an older chunk's
        # stopped output is not taken for the new occupant finishing empty
        slot_gen = [0] * b
        bufs = [[] for _ in range(b)]
        t_assign = [now] * b  # perf_counter_ns
        # eager retirement: a slot is guaranteed stopped once
        # steps_dispatched - refill_step >= guarantee (eff_cap)
        steps_dispatched = 0
        refill_step = [0] * b
        guarantee = [eff_cap(req) if req is not None else 0 for req in first]
        # generations refilled over before their stopping chunk was
        # harvested: (slot, gen) -> (request, tokens so far, t_assign). Their
        # stopping chunk is already in flight, so draining finalizes them.
        pending: dict = {}
        results = {}
        # FIFO retire pointer: refills take the contiguous run of retirable
        # slots from here, so every refill is one contiguous row block
        fifo_q = 0

        def retirable(s):
            return (slot_req[s] is None or harvested[s]
                    or steps_dispatched - refill_step[s] >= guarantee[s])

        def device_live():
            """Some slot may still be emitting (host knowledge)."""
            return any(req is not None and not harvested[s]
                       and steps_dispatched - refill_step[s] < guarantee[s]
                       for s, req in enumerate(slot_req))

        def unfinished():
            return pending or any(req is not None and not harvested[s]
                                  for s, req in enumerate(slot_req))

        # (host outputs, event, generation snapshot, end of its dispatch in ns)
        inflight: list = []
        # live_slot_steps counts a slot while the host believes its occupant
        # may still emit: occupancy = live / total slot-steps bounds the real
        # utilization from above
        self.stats = stats = {"chunks": {}, "refills": {}, "refill_pad_rows": 0, "steps": 0,
                              "graph_steps": 0, "live_slot_steps": 0, "slot_steps": 0,
                              "harvest_wait_s": 0.0, "dispatch_s": 0.0,
                              "refill_dispatch_s": 0.0}

        def pick_chunk_len() -> int:
            """The largest ladder chunk that does not cross the next slot's
            guaranteed retirement."""
            nxt = None
            for s in range(b):
                if slot_req[s] is not None and not harvested[s]:
                    rem = refill_step[s] + guarantee[s] - steps_dispatched
                    if rem > 0 and (nxt is None or rem < nxt):
                        nxt = rem
            if nxt is None:
                return self._chunk_sizes[0]
            for k in self._chunk_sizes:  # descending
                if k <= nxt:
                    return k
            return self._chunk_sizes[-1]

        def dispatch_chunk():
            nonlocal steps_dispatched
            n = pick_chunk_len()
            live_now = sum(1 for s in range(b)
                           if slot_req[s] is not None and not harvested[s]
                           and steps_dispatched - refill_step[s] < guarantee[s])
            t0 = P.now_ns()
            if tr is not None:
                tr.begin("serving.chunk", t0)
            packed = self._chunk(state, n)
            host, done = self._harvestable(packed)
            t1 = P.now_ns()
            if tr is not None:
                tr.end(t1)
            inflight.append((host, done, list(slot_gen), t1))
            stats["dispatch_s"] += (t1 - t0) / 1e9
            steps_dispatched += n
            stats["chunks"][n] = stats["chunks"].get(n, 0) + 1
            stats["steps"] += n
            if self._graph is not None:
                stats["graph_steps"] += n
            stats["live_slot_steps"] += live_now * n
            stats["slot_steps"] += b * n

        def finalize(req, buf, t0, nat, t_stop):
            """The result of `req`, assigned at t0, whose stop came with the
            chunk dispatched by t_stop (ns)."""
            t = P.now_ns()
            results[req.request_id] = res = {"tokens": buf, "length": len(buf),
                                             "stopped": bool(nat), "latency_s": (t - t0) / 1e9}
            if tr is not None:
                tr.interval("serving.request.decode", t0, t_stop, request_id=req.request_id)
                tr.interval("serving.request.harvest", t_stop, t, request_id=req.request_id)
            if on_result is not None:
                on_result(req.request_id, res)

        def harvest_oldest():
            host, done, sgen, t_disp = inflight.pop(0)
            t0 = P.now_ns()
            if tr is not None:
                tr.begin("serving.harvest_wait", t0)
            if done is not None:
                done.synchronize()
            packed = host.numpy()
            t1 = P.now_ns()
            if tr is not None:
                tr.end(t1)
            stats["harvest_wait_s"] += (t1 - t0) / 1e9
            em, stopped, nat = packed[:-2], packed[-2], packed[-1]
            for slot in range(b):
                g = sgen[slot]
                toks = [int(t) for t in em[:, slot] if t >= 0]
                if g == slot_gen[slot]:
                    req = slot_req[slot]
                    if req is None or harvested[slot]:
                        continue
                    bufs[slot].extend(toks)
                    if stopped[slot]:
                        finalize(req, bufs[slot], t_assign[slot], nat[slot], t_disp)
                        harvested[slot] = True
                        bufs[slot] = []
                elif (slot, g) in pending:
                    # an eagerly retired generation: its slot was refilled
                    # while this chunk was in flight
                    req, buf, t0 = pending[(slot, g)]
                    buf.extend(toks)
                    if stopped[slot]:
                        finalize(req, buf, t0, nat[slot], t_disp)
                        del pending[(slot, g)]

        def do_refills():
            nonlocal fifo_q
            while pull(self._refill_sizes[-1]):
                # the contiguous retirable run at the pointer, split at the
                # end of the slot range (a block does not wrap)
                run = 0
                while run < b and retirable((fifo_q + run) % b):
                    run += 1
                avail = min(run, b - fifo_q)
                n = min(avail, len(buffered))
                if n == 0:
                    break
                fits = [k for k in self._refill_sizes if k <= avail]
                tail = len(buffered) == n  # the queue empties with this batch
                if n < self.min_refill and not tail and avail == run and device_live():
                    # wait for a bigger block. Exempt: a fill split at the
                    # end of the slot range, the queue's tail, and an idle
                    # device (waiting would starve it)
                    break
                cover = [k for k in fits if k >= n]
                if tail and cover:
                    r = min(cover)  # pad the queue tail up a ladder size
                else:
                    r = max(k for k in fits if k <= n)  # no padding mid-stream
                n_real = min(r, n)
                batch = [pop_next() for _ in range(n_real)]
                new_caps = np.array([req_cap(req) for req in batch] + [0] * (r - n_real),
                                    np.int64)
                now = P.now_ns()
                for i in range(r):
                    s = fifo_q + i
                    req = batch[i] if i < n_real else None
                    old = slot_req[s]
                    if old is not None and not harvested[s]:
                        # eagerly retired: its stopping chunk is in flight
                        pending[(s, slot_gen[s])] = (old, bufs[s], t_assign[s])
                    slot_req[s] = req
                    harvested[s] = False
                    slot_gen[s] += 1
                    bufs[s] = []
                    t_assign[s] = now
                    refill_step[s] = steps_dispatched
                    guarantee[s] = eff_cap(req) if req is not None else 0
                    if tr is not None and req is not None:
                        tr.interval("serving.request.admit", pulled.pop(id(req)), now,
                                    request_id=req.request_id)
                t0 = P.now_ns()
                if tr is not None:
                    tr.begin("serving.refill", t0, r=r, n_real=n_real)
                self._refill(r, state, stack_prefixes(batch, r), fifo_q,
                             self._to_device(new_caps), n_real)
                t1 = P.now_ns()
                if tr is not None:
                    tr.end(t1)
                stats["refill_dispatch_s"] += (t1 - t0) / 1e9
                stats["refills"][r] = stats["refills"].get(r, 0) + 1
                stats["refill_pad_rows"] += r - n_real
                fifo_q = (fifo_q + r) % b

        # each pass dispatches work, harvests a chunk (draining inflight) or
        # exits; refills go out as soon as their block's guarantee elapses
        while True:
            do_refills()
            while device_live() and len(inflight) < self.pipeline_depth:
                dispatch_chunk()
            if inflight:
                harvest_oldest()
            elif not unfinished() and not pull(1):
                break
        stats["occupancy"] = (round(stats["live_slot_steps"] / stats["slot_steps"], 4)
                              if stats["slot_steps"] else None)
        self.last_stats = stats
        return results


class _GraphStep:
    """A ServingEngine's LM step captured once as a CUDA graph, PyTorch's
    recipe: warm-up runs on a side stream, then the capture on it. The
    graph reads static buffers (the emitted tokens, `pos`, `start` and the
    ring index, [B] and 0-d int64) and `cache`, the engine's ring cache for
    its lifetime, and writes the step's f32 logits into `logits` [B, V],
    which the engine holds as the slots' `last_logits` (refills paste their
    rows there)."""

    WARMUP_STEPS = 2

    @torch.no_grad()
    def __init__(self, engine: ServingEngine, cache):
        b, dev = engine._hi - engine._lo, engine.device
        self.cache = cache
        self.tokens = torch.zeros(b, dtype=torch.int64, device=dev)
        self.pos = torch.full((b,), engine.prompt_len, dtype=torch.int64, device=dev)
        self.start = torch.zeros(b, dtype=torch.int64, device=dev)
        self.index = torch.full((), engine.prompt_len, dtype=torch.int64, device=dev)
        self.graph, self.logits = self._capture(
            lambda: engine._lm_step(self.tokens, cache, self.pos, self.start, self.index)[0], dev)

    @classmethod
    def _capture(cls, step, dev):
        """(the graph of `step()`, its output buffer)."""
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(cls.WARMUP_STEPS):
                step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = step()
        return graph, out

    def replay(self, tokens: torch.Tensor, cache, pos: torch.Tensor, start: torch.Tensor):
        """One step from `cache.index`: copy the inputs in, replay; returns
        the cache with its host index advanced."""
        self.tokens.copy_(tokens)
        self.pos.copy_(pos)
        self.start.copy_(start)
        self.index.fill_(cache.index)
        self.graph.replay()
        return cache._replace(index=cache.index + 1)
