"""K2/K3/K4: the fused per-step logit filter + Gumbel top-2 sampler, and
the filter alone.

Replaces the TPU kernels of clipcap_tpu/ops/pallas/fused_sampler.py:
`_sampler_kernel`, reached through `fused_filter_sample` (K2, the engine's
default sampled step) and `fused_step_sample` (K3, the same kernel with the
engine's pre-filter prologue: raw log P(eos), min-length eos suppression,
the repetition penalty and temperature); and `filt_kernel`, reached through
`fused_filter` (K4, the same top-k/top-p kept set returned as [B, V]
filtered logits, masked = -inf; the kernel's FILTER output mode, which
writes the row back instead of sampling: 29.0 MB at [72, 50257], ~8.6 us
bound by bytes). The CUDA kernel is
csrc/fused_sampler.cu: each row is spread over a cluster of 1-8 blocks
(`cluster_size`) that hold its slices in shared memory, so the logits
cross device memory once; the top-k and top-p cutoffs come from a select
(a value-bucket histogram, then the crossing bucket's tokens resolved
exactly) whose value is replayed through the bisection's 28 steps (the
cutoffs are the bisection's bit for bit), and one Gumbel top-2 pass runs
over the kept tokens. That read (plus the int8 `appears` row for K3)
bounds it on the H100: 14.5 MB at [72, 50257], ~4.3 us; the source's
header says what the design does.

The wrappers launch the kernel for CUDA tensors and take `sampler_plain`
(`fused_filter_plain` for K4), the TPU kernel's math in PyTorch, only for
CPU tensors. `LAUNCHES[name]` counts each wrapper's kernel launches.

Random numbers: with `gumbel_noise` given, both versions use it (tests feed
the same draws to both). Otherwise the kernel draws from an in-kernel
Philox-4x32-10 generator keyed by `seed` and the plain version from a
`torch.Generator` seeded with `seed`: the same Gumbel distribution as
jax.random and the TPU core PRNG, different draws. `row_base` makes row i
draw global row row_base + i's noise: the kernel keys Philox by it, and
the plain version draws row_base + B rows and keeps the last B (on the
CPU, where the generator fills a tensor in order, the rows of a draw over
the whole batch). A data-parallel shard passes its first global row, so a
sampled decode does not depend on the number of ranks; it is 0 elsewhere.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import sampling as S
from . import _build

LAUNCHES = {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}

# bisection iterations of the TPU kernel (fused_sampler.py:45)
DEFAULT_ITERS = 28

_TOPK, _TOPP, _ALT_PROB, _NOISE, _PENALTY, _SUPPRESS, _EOS_LP, _TEMPERATURE = (
    1, 2, 4, 8, 16, 32, 64, 128)

_lib = None
_max_vocab = 0


def _library():
    """The kernel's library with its entry points' ctypes signatures set
    (once, at first use) and its vocabulary limit read."""
    global _lib, _max_vocab
    if _lib is None:
        lib = _build.library("fused_sampler")
        lib.clipcap_fused_sampler.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
               ctypes.c_void_p])
        lib.clipcap_fused_sampler.restype = ctypes.c_int
        lib.clipcap_fused_filter.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.clipcap_fused_filter.restype = ctypes.c_int
        lib.clipcap_sampler_cluster.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.clipcap_sampler_cluster.restype = ctypes.c_int
        lib.clipcap_sampler_max_vocab.argtypes = []
        lib.clipcap_sampler_max_vocab.restype = ctypes.c_int
        _max_vocab = lib.clipcap_sampler_max_vocab()
        _lib = lib
    return _lib


def _check_vocab(vocab: int) -> None:
    _library()
    if vocab > _max_vocab:
        raise ValueError(f"vocab {vocab} exceeds the {_max_vocab} tokens a cluster of blocks "
                         f"holds in shared memory")


def cluster_size(rows: int, vocab: int) -> int:
    """Blocks per row (the thread block cluster's size) of a launch at
    [rows, vocab]: the largest, up to 8, whose rows * C blocks all run at
    once on the H100's 132 SMs (two per SM where shared memory allows),
    else the smallest whose slice fits a block. Builds the kernel's library
    if needed."""
    return _library().clipcap_sampler_cluster(rows, vocab)


def resolve_top_k(top_k, batch: int, vocab: int, device="cuda") -> torch.Tensor:
    """Reference top-k resolution (sampling.py:126-148): 0 disables,
    0<k<1 keeps max(1, floor(k*V)), k>=1 keeps floor(k). Returns [B] f32."""
    return S.resolve_top_k_rows(S.per_row(top_k, batch, device), vocab)


def _filter_plain(x: torch.Tensor, kk: torch.Tensor, pp: torch.Tensor, *, do_topk: bool,
                  do_topp: bool, iters: int) -> torch.Tensor:
    """The TPU kernels' top-k then top-p passes on f32 x [B, V] (kk, pp
    [B, 1]): masked = -inf, kept values untouched."""
    neg = torch.full((), float("-inf"), device=x.device)
    zero = torch.zeros((), device=x.device)
    hi0 = x.amax(dim=-1, keepdim=True)
    if do_topk:
        finite_min = torch.where(torch.isfinite(x), x, torch.full_like(x, float("inf"))
                                 ).amin(dim=-1, keepdim=True)
        lo_k, _ = S.bisect_desc(
            lambda mid: (x >= mid).float().sum(dim=-1, keepdim=True) >= kk,
            finite_min, hi0, iters)
        x = torch.where((kk > 0) & (x < lo_k), neg, x)
    if do_topp:
        m = x.amax(dim=-1, keepdim=True)
        e = torch.exp(x - m)
        probs = e / e.sum(dim=-1, keepdim=True)
        lo_p, _ = S.bisect_desc(
            lambda mid: torch.where(x >= mid, probs, zero).sum(dim=-1, keepdim=True) > pp,
            hi0 - 100.0, hi0, iters)
        x = torch.where((x >= lo_p) | (pp <= 0.0), x, neg)
    return x


def sampler_plain(
    logits: torch.Tensor,  # [B, V]
    kk: torch.Tensor,  # [B] f32 resolved top-k
    pp: torch.Tensor,  # [B] f32 top-p
    seed: int,
    *,
    do_topk: bool,
    do_topp: bool,
    want_alt_prob: bool,
    gumbel_noise: Optional[torch.Tensor] = None,
    iters: int = DEFAULT_ITERS,
    appears: Optional[torch.Tensor] = None,
    penalty: float = 1.0,
    temperature: float = 1.0,
    eos_token_id: Optional[int] = None,
    suppress_eos: Optional[torch.Tensor] = None,
    want_eos_lp: bool = False,
    row_base: int = 0,
):
    """The TPU `_sampler_kernel` step by step in PyTorch. Returns
    (next [B] int32, alt [B] int32, alt_prob [B] f32, eos_lp [B] f32 or None)."""
    x = logits.float()
    b, vocab = x.shape
    dev = x.device
    kk = kk.float().reshape(b, 1)
    pp = pp.float().reshape(b, 1)
    neg = torch.full((), float("-inf"), device=dev)
    zero = torch.zeros((), device=dev)

    eos_lp = None
    if want_eos_lp:
        m0 = x.amax(dim=-1, keepdim=True)
        lse = m0 + torch.log(torch.exp(x - m0).sum(dim=-1, keepdim=True))
        eos_lp = (x[:, eos_token_id:eos_token_id + 1] - lse)[:, 0]
    if suppress_eos is not None:
        col = torch.where(suppress_eos.reshape(b) > 0, neg, x[:, eos_token_id])
        x = torch.cat([x[:, :eos_token_id], col[:, None], x[:, eos_token_id + 1:]], dim=1)
    if penalty != 1.0:
        hit = appears != 0
        x = torch.where(hit, torch.where(x < 0, x * penalty, x / penalty), x)
    if temperature != 1.0:
        x = x * (1.0 / temperature)

    x = _filter_plain(x, kk, pp, do_topk=do_topk, do_topp=do_topp, iters=iters)

    if gumbel_noise is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        gumbel_noise = S.gumbel_like(x.new_empty((row_base + b, vocab)), gen)[row_base:]
    pert = x + gumbel_noise.float()
    iota = torch.arange(vocab, device=dev)
    i1, _ = S.first_index_of_max(pert)
    i2, m2 = S.first_index_of_max(torch.where(iota == i1, neg, pert))
    if want_alt_prob:
        mf = x.amax(dim=-1, keepdim=True)
        sf = torch.exp(x - mf).sum(dim=-1, keepdim=True)
        x_alt = torch.gather(x, 1, i2)
        alt_prob = torch.where(torch.isfinite(m2), torch.exp(x_alt - mf) / sf, zero)[:, 0]
    else:
        alt_prob = torch.zeros(b, device=dev)
    return i1[:, 0].to(torch.int32), i2[:, 0].to(torch.int32), alt_prob, eos_lp


def _launch(counter: str, logits, kk, pp, seed, *, flags, iters, appears=None,
            suppress=None, noise=None, penalty=1.0, temperature=1.0, eos_token_id=None,
            row_base=0):
    b, vocab = logits.shape
    _build.check_cuda_tensor("logits", logits, (torch.float32,))
    _build.check_cuda_tensor("top_k", kk, (torch.float32,), (b,))
    _build.check_cuda_tensor("top_p", pp, (torch.float32,), (b,))
    if appears is not None:
        _build.check_cuda_tensor("appears", appears, (torch.int8,), (b, vocab))
    if suppress is not None:
        _build.check_cuda_tensor("suppress_eos", suppress, (torch.float32,), (b,))
    if noise is not None:
        _build.check_cuda_tensor("gumbel_noise", noise, (torch.float32,), (b, vocab))
    if eos_token_id is not None and not 0 <= eos_token_id < vocab:
        raise ValueError(f"eos_token_id {eos_token_id} outside the vocabulary")
    if not 0 <= row_base < 2**31 - b:
        raise ValueError(f"row_base {row_base} outside [0, 2^31 - rows)")
    _check_vocab(vocab)
    fn = _library().clipcap_fused_sampler
    dev = logits.device
    nxt = torch.empty(b, dtype=torch.int32, device=dev)
    alt = torch.empty(b, dtype=torch.int32, device=dev)
    alt_prob = torch.empty(b, dtype=torch.float32, device=dev)
    eos_lp = torch.empty(b, dtype=torch.float32, device=dev) if flags & _EOS_LP else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = fn(ptr(logits), ptr(kk), ptr(pp), ptr(appears), ptr(suppress), ptr(noise),
                ptr(nxt), ptr(alt), ptr(alt_prob), ptr(eos_lp), b, vocab, flags, iters,
                float(penalty), 1.0 / float(temperature),
                -1 if eos_token_id is None else int(eos_token_id),
                int(seed) & 0xFFFFFFFFFFFFFFFF, int(row_base), _build.stream_handle(dev))
    _build.raise_on_error(counter, rc)
    LAUNCHES[counter] += 1
    return nxt, alt, alt_prob, eos_lp


def _rows(logits, top_k, top_p):
    b, v = logits.shape
    kk = resolve_top_k(top_k, b, v, logits.device).contiguous()
    pp = S.per_row(top_p, b, logits.device).contiguous()
    return kk, pp


def _noise(gumbel_noise, logits):
    return None if gumbel_noise is None else gumbel_noise.to(
        device=logits.device, dtype=torch.float32).contiguous()


def fused_filter_sample(
    logits: torch.Tensor,  # [B, V] f32, post-penalty, post-temperature
    top_k,
    top_p,
    seed: int,  # vary per step
    *,
    do_topk: bool = True,
    do_topp: bool = True,
    want_alt_prob: bool = True,
    gumbel_noise: Optional[torch.Tensor] = None,  # [B, V] injected noise
    iters: int = DEFAULT_ITERS,
    row_base: int = 0,  # the global row of logits' row 0 (see the module doc)
):
    """Filter + sample one decode step (K2). Returns (next [B] int32,
    alt [B] int32, alt_prob [B] f32). do_topk/do_topp skip a filter whose
    setting is disabled everywhere (each costs a bisection)."""
    kk, pp = _rows(logits, top_k, top_p)
    noise = _noise(gumbel_noise, logits)
    if logits.device.type == "cpu":
        return sampler_plain(logits, kk, pp, seed, do_topk=do_topk, do_topp=do_topp,
                             want_alt_prob=want_alt_prob, gumbel_noise=noise,
                             iters=iters, row_base=row_base)[:3]
    flags = ((_TOPK if do_topk else 0) | (_TOPP if do_topp else 0)
             | (_ALT_PROB if want_alt_prob else 0) | (_NOISE if noise is not None else 0))
    return _launch("fused_filter_sample", logits.float().contiguous(), kk, pp, seed,
                   flags=flags, iters=iters, noise=noise, row_base=row_base)[:3]


def fused_step_sample(
    logits: torch.Tensor,  # [B, V] f32 RAW step logits
    top_k,
    top_p,
    seed: int,
    *,
    appears: Optional[torch.Tensor] = None,  # [B, V] bool/int8 token-history mask
    penalty: float = 1.0,
    temperature: float = 1.0,
    eos_token_id: Optional[int] = None,
    suppress_eos: Optional[torch.Tensor] = None,  # [B] bool (min-length gate)
    want_eos_lp: bool = False,
    do_topk: bool = True,
    do_topp: bool = True,
    want_alt_prob: bool = True,
    gumbel_noise: Optional[torch.Tensor] = None,
    iters: int = DEFAULT_ITERS,
    row_base: int = 0,
):
    """K2 preceded by the engine's pre-filter pipeline (K3): raw eos
    logprob, min-length eos suppression, CTRL repetition penalty from the
    `appears` mask, temperature. `penalty` and `temperature` are scalars.
    Returns (next [B], alt [B], alt_prob [B], eos_lp [B] or None)."""
    if penalty != 1.0 and appears is None:
        raise ValueError("penalty != 1 requires the appears mask")
    if (want_eos_lp or suppress_eos is not None) and eos_token_id is None:
        raise ValueError("eos handling requires eos_token_id")
    b, v = logits.shape
    kk, pp = _rows(logits, top_k, top_p)
    noise = _noise(gumbel_noise, logits)
    if appears is not None and penalty != 1.0:
        appears = appears.to(logits.device)
        appears = (appears.view(torch.int8) if appears.dtype == torch.bool
                   else appears.to(torch.int8)).contiguous()
    else:
        appears = None
    suppress = None if suppress_eos is None else \
        suppress_eos.to(device=logits.device, dtype=torch.float32).reshape(b).contiguous()
    if logits.device.type == "cpu":
        return sampler_plain(logits, kk, pp, seed, do_topk=do_topk, do_topp=do_topp,
                             want_alt_prob=want_alt_prob, gumbel_noise=noise, iters=iters,
                             appears=appears, penalty=penalty, temperature=temperature,
                             eos_token_id=eos_token_id, suppress_eos=suppress,
                             want_eos_lp=want_eos_lp, row_base=row_base)
    flags = ((_TOPK if do_topk else 0) | (_TOPP if do_topp else 0)
             | (_ALT_PROB if want_alt_prob else 0) | (_NOISE if noise is not None else 0)
             | (_PENALTY if appears is not None else 0)
             | (_SUPPRESS if suppress is not None else 0)
             | (_EOS_LP if want_eos_lp else 0)
             | (_TEMPERATURE if temperature != 1.0 else 0))
    return _launch("fused_step_sample", logits.float().contiguous(), kk, pp, seed,
                   flags=flags, iters=iters, appears=appears, suppress=suppress, noise=noise,
                   penalty=penalty, temperature=temperature, eos_token_id=eos_token_id,
                   row_base=row_base)


def fused_filter_plain(
    logits: torch.Tensor,  # [B, V]
    kk: torch.Tensor,  # [B] f32 resolved top-k
    pp: torch.Tensor,  # [B] f32 top-p
    *,
    do_topk: bool = True,
    do_topp: bool = True,
    iters: int = DEFAULT_ITERS,
) -> torch.Tensor:
    """The TPU `filt_kernel` step by step in PyTorch: [B, V] f32 filtered
    logits, masked = -inf."""
    b = logits.shape[0]
    return _filter_plain(logits.float(), kk.float().reshape(b, 1), pp.float().reshape(b, 1),
                         do_topk=do_topk, do_topp=do_topp, iters=iters)


def fused_filter(
    logits: torch.Tensor,  # [B, V] f32
    top_k,
    top_p,
    *,
    do_topk: bool = True,
    do_topp: bool = True,
    iters: int = DEFAULT_ITERS,
) -> torch.Tensor:
    """Filter only (K4): the top-k/top-p kept set of fused_filter_sample,
    returned as [B, V] f32 logits with the rest at -inf. For callers that
    need the filtered distribution itself; no decode path calls it."""
    kk, pp = _rows(logits, top_k, top_p)
    if logits.device.type == "cpu":
        return fused_filter_plain(logits, kk, pp, do_topk=do_topk, do_topp=do_topp, iters=iters)
    x = logits.float().contiguous()
    b, vocab = x.shape
    _build.check_cuda_tensor("logits", x, (torch.float32,))
    _check_vocab(vocab)
    fn = _library().clipcap_fused_filter
    out = torch.empty_like(x)
    flags = (_TOPK if do_topk else 0) | (_TOPP if do_topp else 0)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), kk.data_ptr(), pp.data_ptr(), out.data_ptr(), b, vocab, flags,
                iters, _build.stream_handle(x.device))
    _build.raise_on_error("fused_filter", rc)
    LAUNCHES["fused_filter"] += 1
    return out
