"""A PyTorch emulation of the sampler kernel's cutoff selection
(csrc/fused_sampler.cu), held bit for bit against the plain version's
bisections on the CPU.

The kernel does not bisect. It finds the value each bisection converges
to, then replays the 28 bisection steps as scalar arithmetic
(`ok = mid <= v`). That gives the bisection's cutoff bit for bit because
its test at `mid` depends only on the set {x >= mid}:

- top-k: count(x >= mid) >= k exactly when mid <= v_k, the k-th largest
  value counted with multiplicity (-inf when k exceeds the finite count);
- top-p: mass(x >= mid) > p exactly when mid <= v*, the largest value whose
  cumulative mass from the top exceeds p (-inf when none does).

The select: one histogram pass over 1024 value buckets of [lo, max] (the
finite min for top-k; for top-p the larger of that, the top-k cutoff and
max - 28.5; f32 bucket arithmetic as the kernel's) finds the crossing
bucket; its tokens are compacted and, up to
512 of them, resolved by weighing each candidate against the others;
a larger bucket (ties) goes to a radix select over order-preserving uint32
keys (-0.0 mapped to +0.0; digits of 11, 11 and 10 bits; after the first
digit only the crossing digit's tokens, as a compacted list). Here the mass
of a set is taken as the plain version takes it (the same masked f32 sum),
so the emulation must match exactly. The kernel itself sums the mass in
2^-40 fixed point (order-free, so deterministic);
`test_fixed_point_mass_agrees_away_from_ties` runs that rule through the
same select and shows it picks the same cutoff wherever p is not within
1e-5 of a cumulative mass. The one Gumbel top-2 pass over the kept tokens
is held against the plain version's two arg-max passes, and the kept sets
against the Pallas `fused_filter` in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.ops.pallas import fused_sampler as JF
from clipcap_tpu_torch.ops import sampling as S
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS
from clipcap_tpu_torch.tools import sampler_variants as SV

DIGITS = ((21, 11), (10, 11), (0, 10))  # (shift, width) from the top bit down
VBINS = 1024  # value buckets of the first pass
GATHER_MAX = 512  # candidates resolved pairwise; more go to the radix select
MASS_SPAN = 28.5  # top-p buckets [max - 28.5, max]
ITERS = FS.DEFAULT_ITERS
NEG = float("-inf")
PATHS = {"pairwise": 0, "radix": 0}  # which path each select took


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 holding the uint32 key whose order is the floats' order
    (-0.0 and +0.0 share a key)."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)


def key_value(k: int) -> float:
    b = k & 0x7FFFFFFF if k >= 0x80000000 else k ^ 0xFFFFFFFF
    return float(np.array([b], np.uint32).view(np.float32)[0])


def radix_select(keys: torch.Tensor, crosses) -> float:
    """The value v of the largest key t such that crosses(t) holds, where
    crosses(t) is monotone (true for small t) and reads the set
    {key >= t}. Digit by digit: histogram the candidates, take the highest
    bucket whose threshold crosses; after the first digit the candidates are
    the crossing bucket's tokens only. -inf when crosses(0) fails."""
    cand = keys
    prefix = 0
    for level, (shift, width) in enumerate(DIGITS):
        digit = (cand >> shift) & ((1 << width) - 1)
        hist = torch.bincount(digit, minlength=1 << width)
        bins = torch.nonzero(hist).flatten().tolist()  # ascending
        # the crossing bucket: the highest nonempty bin whose threshold crosses
        # (crosses is monotone, so search the bins by bisection)
        lo, hi = 0, len(bins) - 1
        if not crosses(prefix | (bins[0] << shift)):
            if level == 0:
                return NEG
            raise AssertionError("a crossing bucket lost its crossing")
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if crosses(prefix | (bins[mid] << shift)):
                lo = mid
            else:
                hi = mid - 1
        b = bins[lo]
        prefix |= b << shift
        cand = cand[digit == b]  # compaction: the crossing bucket's tokens
    return key_value(prefix)


def value_buckets(x: torch.Tensor, hi0: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The kernel's value bucket of each x: VBINS equal slices of [lo, hi0]
    in f32, a larger bucket holding larger values, everything below lo in
    bucket 0."""
    span = hi0 - lo
    inv_w = (torch.tensor(float(VBINS)) / span if 0 < float(span) < float("inf")
             else torch.tensor(0.0))
    t = (hi0 - x) * inv_w
    return VBINS - 1 - torch.where(t < VBINS - 1, t, torch.tensor(float(VBINS - 1))).to(torch.int64)


def select_cutoff(x: torch.Tensor, live: torch.Tensor, crosses, lo, hi0) -> float:
    """The kernel's select on one row: the largest value v of a live token
    with crosses({live, x >= v}), -inf if none. `crosses` reads a token
    mask. Value buckets find the crossing bucket; its tokens are resolved
    pairwise (by bisection over their sorted values, the same answer) or,
    past GATHER_MAX, by the key radix restricted to the bucket."""
    bucket = value_buckets(x, hi0, lo)
    bins = sorted(set(bucket[live].tolist()))
    if not bins or not crosses(live & (bucket >= bins[0])):
        return NEG
    lo_i, hi_i = 0, len(bins) - 1
    while lo_i < hi_i:
        mid = (lo_i + hi_i + 1) // 2
        if crosses(live & (bucket >= bins[mid])):
            lo_i = mid
        else:
            hi_i = mid - 1
    cand = live & (bucket == bins[lo_i])
    if int(cand.sum()) > GATHER_MAX:
        PATHS["radix"] += 1
        keys = order_keys(x)
        return radix_select(keys[cand], lambda t: crosses(live & (keys >= t)))
    PATHS["pairwise"] += 1
    vals = sorted(set(x[cand].tolist()))
    lo_i, hi_i = 0, len(vals) - 1
    while lo_i < hi_i:
        mid = (lo_i + hi_i + 1) // 2
        if crosses(live & (x >= vals[mid])):
            lo_i = mid
        else:
            hi_i = mid - 1
    return vals[lo_i]


def replay(v: float, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The 28 bisection steps with the test `mid <= v`, in f32."""
    lo, hi = lo.clone(), hi.clone()
    vt = torch.tensor(v, dtype=torch.float32)
    for _ in range(ITERS):
        mid = 0.5 * (lo + hi)
        ok = mid <= vt
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def plain_cutoffs(x, kk, pp, do_topk, do_topp):
    """`_filter_plain`'s bisections, returning lo_k and lo_p [B, 1]
    (None where a filter is off) and the probabilities top-p used."""
    hi0 = x.amax(dim=-1, keepdim=True)
    lo_k = lo_p = probs = None
    if do_topk:
        finite_min = torch.where(torch.isfinite(x), x, torch.full_like(x, float("inf"))
                                 ).amin(dim=-1, keepdim=True)
        lo_k, _ = S.bisect_desc(lambda mid: (x >= mid).float().sum(dim=-1, keepdim=True) >= kk,
                                finite_min, hi0, ITERS)
        x = torch.where((kk > 0) & (x < lo_k), torch.tensor(NEG), x)
    if do_topp:
        m = x.amax(dim=-1, keepdim=True)
        e = torch.exp(x - m)
        probs = e / e.sum(dim=-1, keepdim=True)
        lo_p, _ = S.bisect_desc(
            lambda mid: torch.where(x >= mid, probs, torch.zeros(())).sum(dim=-1, keepdim=True)
            > pp, hi0 - 100.0, hi0, ITERS)
    return lo_k, lo_p, x, probs


def emulate_filter(x, kk, pp, do_topk, do_topp):
    """The kernel's filter: select, replay, mask. Returns the filtered row
    and the cutoffs."""
    b = x.shape[0]
    hi0 = x.amax(dim=-1, keepdim=True)
    finite = torch.isfinite(x)
    finite_min = torch.where(finite, x, torch.full_like(x, float("inf"))).amin(dim=-1, keepdim=True)
    lo_k = torch.empty(b, 1)
    cut_k = torch.full((b, 1), NEG)
    if do_topk:
        for r in range(b):
            need = int(np.ceil(float(kk[r])))
            v_k = select_cutoff(x[r], finite[r], lambda m: int(m.sum()) >= need,
                                finite_min[r, 0], hi0[r, 0])
            lo_k[r] = replay(v_k, finite_min[r], hi0[r])
        cut_k = torch.where(kk > 0, lo_k, cut_k)
        x = torch.where((kk > 0) & (x < lo_k), torch.tensor(NEG), x)
    lo_p = torch.empty(b, 1)
    # top-p buckets from the larger of max - 28.5, the finite min and the top-k cutoff
    lo_mass = torch.maximum(hi0 - MASS_SPAN, torch.maximum(finite_min, cut_k))
    if do_topp:
        m = x.amax(dim=-1, keepdim=True)
        e = torch.exp(x - m)
        probs = e / e.sum(dim=-1, keepdim=True)
        live = torch.isfinite(x)  # -inf where top-k masked
        for r in range(b):
            def crosses(mask, r=r):
                # the plain version's masked sum over the whole batch, read at row r
                rows = torch.zeros_like(x, dtype=torch.bool)
                rows[r] = mask
                return bool(torch.where(rows, probs, torch.zeros(())).sum(
                    dim=-1, keepdim=True)[r, 0] > pp[r, 0])
            v_p = select_cutoff(x[r], live[r], crosses, lo_mass[r, 0], hi0[r, 0])
            lo_p[r] = replay(v_p, hi0[r] - 100.0, hi0[r])
        x = torch.where((x >= lo_p) | (pp <= 0.0), x, torch.tensor(NEG))
    return x, (lo_k if do_topk else None), (lo_p if do_topp else None)


def emulate_top2(xf, g, want_alt_prob=True):
    """One pass over the kept tokens: (value, index) pairs under 'larger
    value, then smaller index'; a slot no finite candidate fills is index 0,
    as the plain version's first-index arg-max over an all -inf row."""
    nxt, alt, alt_prob = [], [], []
    mf = xf.amax(dim=-1)
    sf = torch.exp(xf - mf[:, None]).sum(dim=-1)
    for r in range(xf.shape[0]):
        kept = torch.nonzero(torch.isfinite(xf[r])).flatten()
        pert = xf[r, kept] + g[r, kept]
        fin = torch.isfinite(pert)
        kept, pert = kept[fin], pert[fin]
        order = torch.sort(-pert, stable=True).indices  # kept is ascending: ties keep index order
        top = kept[order[:2]].tolist() + [0, 0]
        nxt.append(top[0])
        alt.append(top[1])
        alt_prob.append(float(torch.exp(xf[r, top[1]] - mf[r]) / sf[r])
                        if len(kept) >= 2 and want_alt_prob else 0.0)
    return (torch.tensor(nxt, dtype=torch.int32), torch.tensor(alt, dtype=torch.int32),
            torch.tensor(alt_prob))


def hard_rows(rng, v):
    """Random, quantised to 0.25 (many ties), -inf columns, all equal, and
    signed zeros beside small values."""
    rows = [rng.normal(size=v) * 3,
            np.round(rng.normal(size=v) * 1.5 * 4) / 4,
            rng.normal(size=v) * 2,
            np.full(v, 0.75),
            np.where(rng.random(v) < 0.5, -0.0, 0.0) + np.where(rng.random(v) < 0.1,
                                                                rng.normal(size=v), 0.0)]
    rows[2][rng.random(v) < 0.3] = -np.inf
    rows[1][: v // 8] = -np.inf
    return np.stack(rows).astype(np.float32)


def _settings(x, kk_list, pp):
    b, v = x.shape
    finite = int(np.isfinite(x).sum(axis=1).min())
    kks = [min(v, k) if k >= 0 else finite + 1 for k in kk_list]
    kk = torch.tensor([kks[r % len(kks)] for r in range(b)], dtype=torch.float32)[:, None]
    return kk, torch.full((b, 1), pp)


CASES = [(v, pp) for v in (512,) for pp in (0.0, 1e-4, 0.5, 0.999, 1.0)]


@pytest.mark.parametrize("v,pp", CASES)
@pytest.mark.parametrize("gates", [(True, True), (True, False), (False, True)],
                         ids=["topk_topp", "topk", "topp"])
def test_select_and_replay_equals_the_bisections(v, pp, gates, rng):
    """lo_k, lo_p and the kept sets bit for bit, for k in {0, 1, 40, V,
    more than the finite count} across rows."""
    do_topk, do_topp = gates
    x = torch.from_numpy(hard_rows(rng, v))
    kk, ppt = _settings(x.numpy(), [0, 1, 40, v, -1], pp)
    want_lo_k, want_lo_p, _, _ = plain_cutoffs(x, kk, ppt, do_topk, do_topp)
    got, lo_k, lo_p = emulate_filter(x, kk, ppt, do_topk, do_topp)
    want = FS._filter_plain(x, kk, ppt, do_topk=do_topk, do_topp=do_topp, iters=ITERS)
    if do_topk:
        on = (kk > 0).flatten()
        assert torch.equal(lo_k[on].view(torch.int32), want_lo_k[on].view(torch.int32))
    if do_topp:
        assert torch.equal(lo_p.view(torch.int32), want_lo_p.view(torch.int32))
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got, want)


@pytest.mark.parametrize("pp", [0.0, 1e-4, 0.5, 0.999, 1.0])
def test_select_and_replay_at_gpt2_vocab(pp):
    """V=50257 (GPT-2's vocabulary), a random row, a row quantised to 0.25
    and an all-equal row (one bucket of 50257 tied tokens): top-k 40 then
    top-p, and top-p alone, bit for bit; the all-equal row's top-k takes
    the radix select."""
    rng = np.random.default_rng(int(pp * 1e4) + 5)
    x = torch.from_numpy(np.stack([rng.normal(size=50257) * 3,
                                   np.round(rng.normal(size=50257) * 3 * 4) / 4,
                                   np.full(50257, -1.25)]).astype(np.float32))
    x[0, 50256] = NEG
    before = PATHS["radix"]
    for k in (40.0, 0.0):
        kk, ppt = torch.full((3, 1), k), torch.full((3, 1), pp)
        want_lo_k, want_lo_p, _, _ = plain_cutoffs(x, kk, ppt, True, True)
        got, lo_k, lo_p = emulate_filter(x, kk, ppt, True, True)
        if k > 0:
            assert torch.equal(lo_k.view(torch.int32), want_lo_k.view(torch.int32))
        assert torch.equal(lo_p.view(torch.int32), want_lo_p.view(torch.int32))
        assert torch.equal(got, FS._filter_plain(x, kk, ppt, do_topk=True, do_topp=True,
                                                 iters=ITERS))
    assert PATHS["radix"] > before


def test_order_keys_order_the_floats_and_merge_signed_zeros():
    vals = torch.tensor([NEG, -3e38, -1.5, -1e-45, -0.0, 0.0, 1e-45, 2.0, 3e38, float("inf")])
    k = order_keys(vals)
    assert int(k[4]) == int(k[5])
    assert bool((k[1:] >= k[:-1]).all()) and bool((k[1:4] > k[:3]).all())
    back = [key_value(int(t)) for t in k.tolist()]
    assert back == [0.0 if float(t) == 0 else float(t) for t in vals]
    assert all(np.copysign(1.0, b) > 0 for b in back[4:6])  # both zeros come back as +0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_point_mass_agrees_away_from_ties(seed):
    """The kernel's top-p mass: each exp(x - max) rounded to 2^-40 and
    summed as integers (any order gives the same bits), with the test
    `mass > floor(p * total)`. Wherever p lies more than 1e-5 (relative)
    from every cumulative mass, its v* and lo_p are the plain version's."""
    rng = np.random.default_rng(100 + seed)
    v = 2048
    x = torch.from_numpy((rng.normal(size=(1, v)) * 3).astype(np.float32))
    m = x.amax(dim=-1, keepdim=True)
    hi0 = m[0, 0]
    e = torch.exp(x - m)
    q = torch.round(e.double() * 2.0 ** 40).to(torch.int64)[0]
    total = int(q.sum())
    probs = e / e.sum()
    cum = np.cumsum(np.sort(probs.double().numpy()[0])[::-1])
    checked = 0
    for pp in rng.random(40).astype(np.float32):
        if np.min(np.abs(cum - pp)) <= 1e-5 * pp:
            continue
        tq = int(np.floor(float(pp) * total))
        lo = torch.maximum(hi0 - MASS_SPAN, x.amin())
        v_fix = select_cutoff(x[0], q != 0, lambda mk: int(q[mk].sum()) > tq, lo, hi0)
        v_plain = select_cutoff(x[0], torch.isfinite(x[0]), lambda mk: bool(
            torch.where(mk, probs[0], torch.zeros(())).sum() > float(pp)), lo, hi0)
        assert v_fix == v_plain
        assert torch.equal(replay(v_fix, m[0] - 100.0, m[0]), replay(v_plain, m[0] - 100.0, m[0]))
        checked += 1
    assert checked >= 30


@pytest.mark.parametrize("gates", [(True, True), (False, True), (True, False)],
                         ids=["topk_topp", "topp", "topk"])
def test_one_top2_pass_over_the_kept_set_equals_two_argmax_passes(gates, rng):
    """next, alt and alt_prob of the one-pass top-2 (Philox-free: injected
    noise) equal sampler_plain's, with a singleton kept set (top-k 1 or
    top-p 1e-4 on a row whose max stands alone), an all-tied row and a
    quantised row with top-k 1 (its tied maxima all kept)."""
    do_topk, do_topp = gates
    v = 512
    x = torch.from_numpy(hard_rows(rng, v))
    x[0, 3] = 40.0  # row 0: one token holds all the mass
    b = x.shape[0]
    kk = torch.tensor([1.0, 1.0, 40.0, 7.0, 0.0])
    pp = torch.tensor([1e-4, 0.5, 0.999, 0.3, 0.9])
    g = torch.from_numpy(rng.gumbel(size=(b, v)).astype(np.float32))
    g[3] = 0.0  # all-equal row, equal noise: the first index wins every tie
    xf, _, _ = emulate_filter(x, kk[:, None], pp[:, None], do_topk, do_topp)
    got = emulate_top2(xf, g)
    want = FS.sampler_plain(x, kk, pp, 0, do_topk=do_topk, do_topp=do_topp,
                            want_alt_prob=True, gumbel_noise=g)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    assert int(got[1][0]) == 0 and float(got[2][0]) == 0.0  # singleton: alt 0, prob 0


def test_emulated_kept_set_equals_pallas_fused_filter(rng):
    """V=512: the emulated kept set and values equal the Pallas
    `fused_filter`'s in interpret mode."""
    x = hard_rows(rng, 512)
    kk = np.asarray([0.0, 1.0, 40.0, 512.0, 5.0], np.float32)
    pp = np.asarray([0.5, 0.999, 1e-4, 1.0, 0.0], np.float32)
    want = JF.fused_filter(jnp.asarray(x), jnp.asarray(kk), jnp.asarray(pp), interpret=True,
                           block_rows=1)
    got, _, _ = emulate_filter(torch.from_numpy(x), torch.from_numpy(kk)[:, None],
                               torch.from_numpy(pp)[:, None], True, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(SV.VARIANTS))
def test_sampler_variant_edits_still_apply_to_the_kernel_source(name):
    """tools/sampler_variants.py builds edited copies of the kernel source;
    each edit must still find its text exactly once."""
    src = SV.variant_source(name)
    assert "sampler_kernel" in src and src != (FS._build.CSRC / "fused_sampler.cu").read_text()
