"""K1's layout contract and its f32 arithmetic, on the CPU.

The CUDA kernel reads q, k and v as strided views of the packed qkv
projection; `attention_layout` is the Python check of what it accepts, and
the ViT block hands it those views without copies. The kernel computes f32
attention with error-compensated 3xTF32 tensor-core products; an emulation
of that split in torch (TF32 rounding by bit masking, as cvt.rna.tf32.f32)
stays inside the f32 tolerance that chip_smoke.py holds the kernel to
(atol 2e-5, rtol 1e-5), and single-pass TF32 does not. The kernel itself is
held against the plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.ops.pallas.fused_attention import fused_attention as jax_fused_attention
from clipcap_tpu_torch.core.config import ViTConfig
from clipcap_tpu_torch.models import vit as TV
from clipcap_tpu_torch.models.common import make_generator
from clipcap_tpu_torch.ops.kernels import fused_attention as FA
from clipcap_tpu_torch.tools import k1_variants as K1V

F32_TOL = dict(atol=2e-5, rtol=1e-5)
# chip_smoke.check_attention's shapes (T, H, dh)
SMOKE_SHAPES = [(50, 12, 64), (257, 16, 64), (577, 12, 64), (50, 8, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and torch's default pool (one thread per core) in each
    would oversubscribe the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def packed_views(x: torch.Tensor, heads: int):
    """The ViT block's split: [B, T, 3*H*dh] -> three [B, T, H, dh] views."""
    b, t, three_d = x.shape
    return tuple(y.reshape(b, t, heads, three_d // 3 // heads) for y in x.chunk(3, dim=-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 50, 4, 64), (1, 70, 2, 128)])
def test_attention_layout_accepts_packed_qkv_views(shape, dtype):
    b, t, h, dh = shape
    q, k, v = packed_views(torch.randn(b, t, 3 * h * dh).to(dtype), h)
    assert not q.is_contiguous()
    assert FA.attention_layout(q, k, v) == ((t * 3 * h * dh, 3 * h * dh),) * 3
    c = torch.randn(b, t, h, dh).to(dtype)
    assert FA.attention_layout(c, c, c) == ((t * h * dh, h * dh),) * 3


def _bad_layouts():
    good = torch.randn(2, 50, 4, 64)
    packed = torch.randn(2, 50, 3 * 256 + 2)  # token stride 770: not 16-byte aligned
    return {
        "last stride": (torch.randn(2, 50, 4, 128)[..., ::2], "last stride"),
        "token stride": (packed_views(packed[..., :768], 4)[0], "token stride"),
        "head stride": (torch.randn(2, 50, 8, 64)[:, :, ::2], "head stride"),
        "batch stride": (torch.randn(3 * 50 * 256).as_strided((2, 50, 4, 64),
                                                              (50 * 256 + 2, 256, 64, 1)),
                         "batch stride"),
        "base address": (torch.randn(2, 50, 3 * 256)[..., 1:257].reshape(2, 50, 4, 64),
                         "aligned"),
        "shape": (torch.randn(2, 49, 4, 64), "shape"),
        "dtype": (good.to(torch.bfloat16), "dtype"),
        "head_dim": (torch.randn(2, 50, 8, 32), "shape"),
    }


@pytest.mark.parametrize("case", sorted(_bad_layouts()))
def test_attention_layout_rejects(case):
    bad, words = _bad_layouts()[case]
    good = torch.randn(2, 50, 4, 64)
    with pytest.raises(ValueError, match=words):
        FA.attention_layout(good, bad, good)


def test_attention_layout_rejects_unsupported_sizes():
    for x, words in ((torch.randn(1, 10, 2, 32), "head_dim"),
                     (torch.randn(1, FA.MAX_SEQ + 1, 1, 64), "too long"),
                     (torch.randn(1, 10, 2, 64).double(), "dtype"),
                     (torch.randn(10, 2, 64), r"\[B, T, H, dh\]")):
        with pytest.raises(ValueError, match=words):
            FA.attention_layout(x, x, x)


@pytest.mark.parametrize("shape", [(2, 50, 4, 64), (1, 70, 2, 128)])
def test_fused_attention_on_packed_views_matches_plain_and_pallas(shape, rng):
    b, t, h, dh = shape
    qkv = rng.normal(size=(b, t, 3 * h * dh)).astype(np.float32)
    q, k, v = packed_views(torch.from_numpy(qkv), h)
    before = dict(FA.LAUNCHES)
    got = FA.fused_attention(q, k, v)
    plain = FA.fused_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
    want = jax_fused_attention(*(jnp.asarray(x.contiguous().numpy()) for x in (q, k, v)),
                               interpret=True)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **F32_TOL)
    assert got.shape == (b, t, h, dh)
    assert FA.LAUNCHES == before


def test_vit_block_hands_the_kernel_views_of_the_packed_projection(monkeypatch):
    """With the kernel's gate open, the block passes the three slices of its
    qkv projection as they are (no copies), in a layout the kernel takes,
    and its output equals the block's own CPU attention path."""
    cfg = ViTConfig(image_size=32, patch_size=16, width=128, layers=1, heads=2)
    block = TV.ViTBlock(cfg, make_generator(0, "cpu"), "cpu", torch.float32)
    x = torch.randn(3, cfg.seq_len, cfg.width, generator=make_generator(1, "cpu"))
    with torch.no_grad():
        want = block(x)
    seen = []

    def kernel(q, k, v):
        seen.append(FA.attention_layout(q, k, v))
        assert not any(y.is_contiguous() for y in (q, k, v))
        assert q.untyped_storage().data_ptr() == v.untyped_storage().data_ptr()
        return FA.fused_attention_plain(q, k, v)

    monkeypatch.setattr(TV, "use_kernel_attention", lambda t, dh, y: True)
    monkeypatch.setattr(TV, "fused_attention", kernel)
    with torch.no_grad():
        got = block(x)
    t, d = cfg.seq_len, cfg.width
    assert seen == [((t * 3 * d, 3 * d),) * 3]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest, ties away
    from zero (the bits are sign-magnitude, so adding half an ulp of the
    magnitude and masking rounds away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on TF32 tensor cores: products of TF32 values are exact in f32
    and summed in f32. passes=3 is the kernel's split, big*big + big*small +
    small*big; passes=1 is plain TF32."""
    ab, bb = tf32_round(a), tf32_round(b)
    if passes == 1:
        return ab @ bb
    asm, bsm = tf32_round(a - ab), tf32_round(b - bb)
    return asm @ bb + ab @ bsm + ab @ bb


def emulated_kernel(q, k, v, passes: int) -> torch.Tensor:
    """The kernel's f32 arithmetic over [B, T, H, dh]: TF32 products for
    q.k^T and p.v, f32 softmax with the sum taken before the division."""
    dh = q.shape[-1]
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    s = tf32_product(qh, kh.transpose(-1, -2), passes) * dh**-0.5
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = tf32_product(p, vh, passes) / p.sum(dim=-1, keepdim=True)
    return out.permute(0, 2, 1, 3)


def test_tf32_round_is_round_to_nearest_ties_away():
    ulp = 2.0**-10
    x = torch.tensor([1 + ulp / 4, 1 + ulp * 3 / 4, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp * 3 / 2],
                     dtype=torch.float32)
    want = torch.tensor([1, 1 + ulp, 1 + ulp, -(1 + ulp), 1 + 2 * ulp], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)


@pytest.mark.parametrize("shape", SMOKE_SHAPES, ids=lambda s: "T{}_H{}_dh{}".format(*s))
def test_3xtf32_split_holds_the_f32_gate_and_plain_tf32_does_not(shape, rng):
    t, h, dh = shape
    q, k, v = (torch.from_numpy(rng.normal(size=(1, t, h, dh)).astype(np.float32))
               for _ in range(3))
    want = FA.fused_attention_plain(q, k, v).numpy()
    split = emulated_kernel(q, k, v, passes=3).numpy()
    np.testing.assert_allclose(split, want, **F32_TOL)
    single = emulated_kernel(q, k, v, passes=1).numpy()
    bad = np.abs(single - want) > F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(want)
    assert bad.any(), "plain TF32 unexpectedly held the f32 tolerance"


@pytest.mark.parametrize("name", sorted(K1V.VARIANTS))
def test_k1_variant_edits_still_apply_to_the_kernel_source(name):
    """The measurement tool edits copies of the kernel source by exact text;
    each edit must find its text once in the kernel as it is."""
    src = K1V.variant_source(name)
    assert src != (FA._build.CSRC / "fused_attention.cu").read_text()
    if name == "clocks":
        assert src.count("STAMP(") == 6 and "k1_read_clocks" in src

