"""The port's Gen-B modules against the JAX package's, on the CPU.

- WordPiece: ids and decoded text equal to JAX's tokenizer and to HF's
  BertTokenizer on tests/test_genb_sampling.py's vocabulary and texts;
- `hetero.sample`: captions, parameters, tokens and eos_prob equal to
  JAX's (eos_prob at rtol 1e-5) on test_genb_sampling.py's tokenizer and
  config, with JAX's per-run, per-step Gumbel draws injected;
- the BLIP captioner's greedy tokens equal HF's BlipForConditionalGeneration
  (as tests/test_blip_captioner_golden.py), through the port's importers;
- `itm_score`/`itc_score` against JAX's (rtol 1e-5) and against HF's
  BlipForImageTextRetrieval (atol 1e-5, rtol 1e-4, JAX's bound);
- a tiny CLIP ResNet against JAX's `clip_resnet.apply` (rtol 1e-4);
- both cascades against JAX's;
- every BLIP and ResNet converter against JAX's, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import hetero as JH
from clipcap_tpu.models import blip_retrieval as JBR
from clipcap_tpu.models import blip_text as JB
from clipcap_tpu.models import clip_resnet as JR
from clipcap_tpu.rank import cascade as JCAS
from clipcap_tpu.tokenizers.wordpiece import WordPieceTokenizer as JaxWordPiece
from clipcap_tpu.tools import import_weights as JW
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.decode import hetero as TH
from clipcap_tpu_torch.models import blip_retrieval as TBR
from clipcap_tpu_torch.models import blip_text as TB
from clipcap_tpu_torch.models import clip_resnet as TR
from clipcap_tpu_torch.models.vit import ViT
from clipcap_tpu_torch.rank import cascade as TCAS
from clipcap_tpu_torch.tokenizers.wordpiece import WordPieceTokenizer
from clipcap_tpu_torch.tools import import_weights as TW

# tests/test_genb_sampling.py's vocabulary and text config
BLIP_VOCAB = (
    "[PAD] [UNK] [CLS] [SEP] [MASK] a picture of the cat dog man surf ##board "
    "riding wave on top sitting ##s , . ! wooden bench park green grass two "
    "people walking beach with in [DEC] [ENC]"
).split()
TEXT = dict(vocab_size=len(BLIP_VOCAB), hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64, encoder_width=24, embed_dim=16)
VIT = dict(image_size=16, patch_size=8, width=24, layers=1, heads=4, mlp_ratio=2.0,
           output_dim=None, style="blip")
TEXTS = ["a picture of the cat", "Two people WALKING on the beach!",
         "a man riding a surfboard, on top of a wave.", "unknownword cat", "Café  naïve dog"]
RN = dict(layers=(1, 2, 1, 1), width=8, output_dim=12, heads=4, image_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("wp") / "vocab.txt"
    path.write_text("\n".join(BLIP_VOCAB) + "\n")
    return path


def test_wordpiece_matches_jax_and_hf(vocab_file):
    from transformers import BertTokenizer

    tok = WordPieceTokenizer.from_vocab_file(str(vocab_file))
    jtok = JaxWordPiece.from_vocab_file(str(vocab_file))
    hf = BertTokenizer(str(vocab_file), do_lower_case=True)
    for name in ("bos_token_id", "sep_token_id", "enc_token_id", "cls_token_id",
                 "all_special_ids", "vocab_size"):
        assert getattr(tok, name) == getattr(jtok, name), name
    assert (tok.bos_token_id, tok.sep_token_id, tok.enc_token_id) == (
        BLIP_VOCAB.index("[DEC]"), BLIP_VOCAB.index("[SEP]"), BLIP_VOCAB.index("[ENC]"))
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == jtok.encode(text) == hf.encode(text), text
        assert tok.tokenize(text) == jtok.tokenize(text)
        assert tok.decode(ids) == jtok.decode(ids) == hf.decode(ids, skip_special_tokens=True)
    # JAX's basic tokenizer drops a tab or newline as a control character
    # (category Cc) where HF's splits on it: kept in the port (ROADMAP.md
    # section 3)
    text = "the cat\tdog"
    assert tok.encode(text) == jtok.encode(text) != hf.encode(text)


def _run_keys(seed: int, runs: int):
    """hetero.sample's per-run keys: rng, run_rng = split(rng)."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(runs):
        rng, run = jax.random.split(rng)
        out.append(run)
    return out


def _step_gumbel(key, n: int, shape) -> torch.Tensor:
    """generate's per-step draws from a run's key."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, dtype=jnp.float32)))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("kw", [
    # test_genb_sampling.py::test_hetero_sample_semantics
    dict(top_p=np.array([0.9, 0.5, 0.9, 0.5]), top_k=0.0, min_len=np.array([2, 2, 5, 5]),
         max_len=np.array([8, 8, 8, 8]), force_eos_log_prob=0.0),
    # top-k and top-p per slot, force-eos and alternate continuation on, two images
    dict(top_p=np.array([0.3, 0.6, 0.95, 0.0]), top_k=np.array([3.0, 0.0, 8.0, 5.0]),
         min_len=np.array([1, 2, 3, 0]), max_len=np.array([5, 7, 6, 9]),
         force_eos_log_prob=float(np.log(0.05)), min_alternate_prob=0.02, images=2),
])
def test_hetero_sample_matches_jax(vocab_file, kw):
    kw = dict(kw)
    images = kw.pop("images", 1)
    tok = WordPieceTokenizer.from_vocab_file(str(vocab_file))
    jtok = JaxWordPiece.from_vocab_file(str(vocab_file))
    jcfg = JC.BlipTextConfig(**TEXT)
    params = JB.init(jax.random.PRNGKey(0), jcfg)
    img = np.array(jax.random.normal(jax.random.PRNGKey(1), (images, 6, 24)))
    common = dict(sample_count=4, repetition_penalty=1.3, num_runs=2, **kw)
    want = JH.sample(jnp.asarray(img), params, jcfg, jtok, rng=jax.random.PRNGKey(2), **common)
    n = int(kw["max_len"].max()) + 1
    noise = [_step_gumbel(k, n, (4 * images, TEXT["vocab_size"])) for k in _run_keys(2, 2)]
    text = convert.load(TB.BlipText(TC.BlipTextConfig(**TEXT), device="cpu"),
                        convert.blip_text_state_dict(_np(params)))
    got = TH.sample(torch.from_numpy(img), text, tok, gumbel_noise=noise, **common)
    assert got[0] == want[0] and got[1] == want[1]
    assert len(got[0]) == len(got[2]) and got[0]
    for g, w in zip(got[2], want[2]):
        assert g["tokens"] == w["tokens"]
        np.testing.assert_allclose(g["eos_prob"], np.asarray(w["eos_prob"]), rtol=1e-5)


# --- the BLIP captioner against HF (tests/test_blip_captioner_golden.py) ----------------

HF_BOS, HF_EOS, HF_PAD = 60, 61, 0
HF_TEXT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
               max_position_embeddings=32, encoder_width=24, layer_norm_epsilon=1e-12)
HF_VIT = dict(image_size=16, patch_size=8, width=24, layers=1, heads=4, mlp_ratio=2.0,
              output_dim=None, style="blip", layer_norm_epsilon=1e-5)


def _hf_configs():
    from transformers import BlipTextConfig, BlipVisionConfig

    text = BlipTextConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          max_position_embeddings=32, encoder_hidden_size=24,
                          hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                          bos_token_id=HF_BOS, eos_token_id=HF_EOS, pad_token_id=HF_PAD,
                          sep_token_id=HF_EOS, is_decoder=True, attn_implementation="eager")
    vision = BlipVisionConfig(image_size=16, patch_size=8, hidden_size=24, num_hidden_layers=1,
                              num_attention_heads=4, intermediate_size=48, layer_norm_eps=1e-5,
                              attention_dropout=0.0, attn_implementation="eager")
    return text, vision


@pytest.fixture(scope="module")
def hf_captioner():
    from transformers import BlipConfig, BlipForConditionalGeneration

    torch.manual_seed(0)
    text, vision = _hf_configs()
    return BlipForConditionalGeneration(BlipConfig(text_config=text.to_dict(),
                                                   vision_config=vision.to_dict())).eval()


def test_blip_captioner_greedy_matches_hf(hf_captioner):
    hf = hf_captioner
    sd = hf.state_dict()
    vit_cfg, text_cfg = TC.ViTConfig(**HF_VIT), TC.BlipTextConfig(**HF_TEXT)
    visual = convert.load(ViT(vit_cfg, device="cpu"), TW.blip_vit_from_hf_state_dict(sd, vit_cfg))
    text = convert.load(TB.BlipText(text_cfg, device="cpu"),
                        TW.blip_text_from_hf_state_dict(sd, text_cfg, prefix="text_decoder."))
    torch.manual_seed(1)
    pixels = torch.randn(2, 3, 16, 16)
    n_new = 10
    with torch.no_grad():  # the reference loop: the whole decoder again per token
        img = hf.vision_model(pixel_values=pixels).last_hidden_state
        inputs = torch.full((2, 1), HF_BOS, dtype=torch.long)
        for _ in range(n_new):
            logits = hf.text_decoder(input_ids=inputs, encoder_hidden_states=img,
                                     encoder_attention_mask=torch.ones(img.shape[:-1],
                                                                       dtype=torch.long)).logits
            inputs = torch.cat([inputs, logits[:, -1].argmax(-1, keepdim=True)], dim=-1)
        feats = visual(pixels, output="tokens")
    np.testing.assert_allclose(feats.numpy(), img.numpy(), rtol=1e-4, atol=1e-5)
    out = TE.generate(TB.decoder_lm(text, feats), torch.full((2, 1), HF_BOS),
                      TE.GenerationSettings(max_new_tokens=n_new, greedy=True,
                                            eos_token_id=HF_EOS, max_length=n_new + 1,
                                            pad_token_id=HF_PAD), device="cpu")
    for row in range(2):
        got = out["tokens"][row][: int(out["lengths"][row])].tolist()
        assert got == inputs[row, 1:].tolist()[: len(got)] and got, row
        if len(got) < n_new:
            assert got[-1] == HF_EOS


# --- ITM / ITC -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def retrieval():
    jv, jt = JC.ViTConfig(**VIT), JC.BlipTextConfig(**TEXT)
    params = JBR.init(jax.random.PRNGKey(0), jv, jt)
    model = convert.load(TBR.BlipRetrieval(TC.ViTConfig(**VIT), TC.BlipTextConfig(**TEXT),
                                           device="cpu"),
                         convert.blip_retrieval_state_dict(_np(params)))
    return params, model


def test_itm_itc_match_jax(retrieval):
    params, model = retrieval
    jt = JC.BlipTextConfig(**TEXT)
    pixels = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 3, 16, 16)))
    toks = np.array([[2, 5, 6, 7, 3, 0], [2, 9, 10, 26, 28, 3]])
    mask = np.array([[1, 1, 1, 1, 1, 0], [1] * 6])
    img = JBR.encode_image(params, JC.ViTConfig(**VIT), jnp.asarray(pixels))
    timg = TBR.encode_image(model, torch.from_numpy(pixels))
    np.testing.assert_allclose(timg.numpy(), np.asarray(img), rtol=1e-5, atol=1e-6)
    img2, timg2 = jnp.repeat(img, 2, axis=0), timg.repeat_interleave(2, 0)
    for j_fn, t_fn in ((JBR.itm_score, TBR.itm_score), (JBR.itc_score, TBR.itc_score)):
        want = j_fn(params, jt, jnp.asarray(toks), img2, jnp.asarray(mask))
        got = t_fn(model, torch.from_numpy(toks), timg2, torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_retrieval_import_matches_jax_and_hf():
    from transformers import BlipConfig, BlipForImageTextRetrieval

    torch.manual_seed(0)
    text, vision = _hf_configs()
    hf = BlipForImageTextRetrieval(BlipConfig(text_config=text.to_dict(),
                                              vision_config=vision.to_dict(),
                                              image_text_hidden_size=16)).eval()
    sd = hf.state_dict()
    vit_cfg, text_cfg = TC.ViTConfig(**HF_VIT), TC.BlipTextConfig(**HF_TEXT, embed_dim=16)
    got = TW.blip_retrieval_from_hf_state_dict(sd, vit_cfg, text_cfg)
    want = convert.blip_retrieval_state_dict(_np(JW.blip_retrieval_from_hf_state_dict(
        sd, JC.ViTConfig(**HF_VIT), JC.BlipTextConfig(**HF_TEXT, embed_dim=16))))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = convert.load(TBR.BlipRetrieval(vit_cfg, text_cfg, device="cpu"), got)
    torch.manual_seed(1)
    pixels = torch.randn(2, 3, 16, 16)
    tokens = torch.randint(0, 64, (2, 7))
    mask = torch.ones(2, 7, dtype=torch.long)
    with torch.no_grad():
        itm = torch.softmax(hf(input_ids=tokens, pixel_values=pixels, attention_mask=mask,
                               use_itm_head=True).itm_score, dim=1)[:, 1]
        itc = hf(input_ids=tokens, pixel_values=pixels, attention_mask=mask,
                 use_itm_head=False).itm_score.diag()
    img = TBR.encode_image(model, pixels)
    for ref, fn in ((itm, TBR.itm_score), (itc, TBR.itc_score)):
        np.testing.assert_allclose(fn(model, tokens, img, mask).numpy(), ref.numpy(),
                                   atol=1e-5, rtol=1e-4)


# --- converters ----------------------------------------------------------------------


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_blip_converters_match_jax(hf_captioner):
    from transformers import BlipTextModel

    sd = hf_captioner.state_dict()
    jv, tv = JC.ViTConfig(**HF_VIT), TC.ViTConfig(**HF_VIT)
    jt, tt = JC.BlipTextConfig(**HF_TEXT), TC.BlipTextConfig(**HF_TEXT)
    # the vision tower, from the whole checkpoint and from the bare vision model
    _same(TW.blip_vit_from_hf_state_dict(sd, tv),
          convert.vit_state_dict(_np(JW.blip_vit_from_hf_state_dict(sd, jv))))
    bare = {k[len("vision_model."):]: v for k, v in sd.items() if k.startswith("vision_model.")}
    _same(TW.blip_vit_from_hf_state_dict(bare, tv),
          convert.vit_state_dict(_np(JW.blip_vit_from_hf_state_dict(bare, jv))))
    # the text decoder: "bert."-rooted with its MLM head, and a bare text model
    _same(TW.blip_text_from_hf_state_dict(sd, tt, prefix="text_decoder."),
          convert.blip_text_state_dict(_np(JW.blip_text_from_hf_state_dict(
              sd, jt, prefix="text_decoder."))))
    text_cfg, _ = _hf_configs()
    plain = BlipTextModel(text_cfg, add_pooling_layer=False).state_dict()
    got = TW.blip_text_from_hf_state_dict(plain, tt)
    assert not any(k.startswith("cls_") for k in got)
    _same(got, convert.blip_text_state_dict(_np(JW.blip_text_from_hf_state_dict(plain, jt))))
    convert.load(TB.BlipText(tt, lm_head=False, device="cpu"), got)


def openai_resnet_state_dict(rn: dict, txt: dict, seed: int = 0) -> dict:
    """A seeded OpenAI-layout CLIP ResNet state dict: the `visual.*` tower
    (BatchNorm statistics away from identity) and the text tower."""
    from test_torch_import_weights import openai_clip_state_dict

    rng = np.random.default_rng(seed)

    def w(*shape, s=0.1):
        return (rng.normal(size=shape) * s).astype(np.float32)

    def bn(p, c):
        return {f"{p}.weight": 1 + w(c), f"{p}.bias": w(c), f"{p}.running_mean": w(c),
                f"{p}.running_var": 1 + np.abs(w(c)), f"{p}.num_batches_tracked": np.array(0)}

    width = rn["width"]
    sd = {"visual.conv1.weight": w(width // 2, 3, 3, 3), **bn("visual.bn1", width // 2),
          "visual.conv2.weight": w(width // 2, width // 2, 3, 3), **bn("visual.bn2", width // 2),
          "visual.conv3.weight": w(width, width // 2, 3, 3), **bn("visual.bn3", width)}
    inplanes = width
    for stage, blocks in enumerate(rn["layers"]):
        planes = width * 2**stage
        for j in range(blocks):
            p = f"visual.layer{stage + 1}.{j}"
            sd.update({f"{p}.conv1.weight": w(planes, inplanes, 1, 1), **bn(f"{p}.bn1", planes),
                       f"{p}.conv2.weight": w(planes, planes, 3, 3), **bn(f"{p}.bn2", planes),
                       f"{p}.conv3.weight": w(planes * 4, planes, 1, 1),
                       **bn(f"{p}.bn3", planes * 4)})
            if j == 0:
                sd.update({f"{p}.downsample.0.weight": w(planes * 4, inplanes, 1, 1),
                           **bn(f"{p}.downsample.1", planes * 4)})
            inplanes = planes * 4
    spacial = rn["image_size"] // 32
    sd["visual.attnpool.positional_embedding"] = w(spacial**2 + 1, inplanes)
    for name in ("q", "k", "v"):
        sd[f"visual.attnpool.{name}_proj.weight"] = w(inplanes, inplanes, s=inplanes**-0.5)
        sd[f"visual.attnpool.{name}_proj.bias"] = w(inplanes)
    sd["visual.attnpool.c_proj.weight"] = w(rn["output_dim"], inplanes, s=inplanes**-0.5)
    sd["visual.attnpool.c_proj.bias"] = w(rn["output_dim"])
    vis = dict(image_size=32, patch_size=16, width=8, layers=0, output_dim=8)
    sd.update({k: v for k, v in openai_clip_state_dict(vis, txt, seed + 1).items()
               if not k.startswith("visual.")})
    return sd


def test_clip_resnet_matches_jax():
    txt = dict(vocab_size=40, context_length=8, width=16, layers=1, output_dim=12)
    sd = openai_resnet_state_dict(RN, txt)
    jcfg = JW.clip_resnet_config_from_state_dict(sd)
    tcfg = TW.clip_resnet_config_from_state_dict(sd)
    assert tcfg == TR.ResNetConfig(**RN) and jcfg == JR.ResNetConfig(**RN)
    jparams = JW.clip_resnet_from_openai_state_dict(sd, jcfg)
    got = TW.clip_resnet_from_openai_state_dict(sd, tcfg)
    _same(got, convert.clip_resnet_state_dict(_np(jparams)))
    model = convert.load(TR.ModifiedResNet(tcfg, device="cpu"), got)
    pixels = np.random.default_rng(3).standard_normal((2, 3, 64, 64)).astype(np.float32)
    want = JR.apply(jparams, jcfg, jnp.asarray(pixels))
    with torch.no_grad():
        out = model(torch.from_numpy(pixels))
    assert out.shape == (2, RN["output_dim"])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # JAX's random init converted, and the variants' table
    init = JR.init(jax.random.PRNGKey(0), jcfg)
    convert.load(TR.ModifiedResNet(tcfg, device="cpu"), convert.clip_resnet_state_dict(_np(init)))
    for name in ("RN50", "RN101", "RN50x4", "RN50x16", "RN50x64"):
        assert (TR.ResNetConfig.variant(name).__dict__ == JR.ResNetConfig.variant(name).__dict__)


def test_cascades_match_jax():
    caps = [f"c{i}" for i in range(9)]
    rng = np.random.default_rng(0)
    table = {c: rng.standard_normal(3) for c in caps}

    def scorer(j):
        return lambda cs: [float(table[c][j]) for c in cs]

    for shortlist, top_n in ((5, 3), (3, 2), (9, 9)):
        assert (TCAS.two_stage_rank(caps, scorer(0), scorer(1), shortlist, top_n)
                == JCAS.two_stage_rank(caps, scorer(0), scorer(1), shortlist, top_n))
    stages = [(scorer(0), -0.5), (scorer(1), 5.0), (scorer(2), 0.0)]
    for frac in (0.1, 0.34, 1.0):
        assert (TCAS.threshold_cascade(caps, stages, frac)
                == JCAS.threshold_cascade(caps, stages, frac))
    assert TCAS.two_stage_rank([], scorer(0), scorer(1)) == []
