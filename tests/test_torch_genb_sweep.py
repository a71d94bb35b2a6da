"""The rest of the port's Gen B against the JAX package on the CPU: the TPE
optimizer, the COCO sampling sweep (cli/sweep.py), human-eval preparation
(cli/human_eval.py) and Gumbel caption optimization
(tools/gumbel_caption_opt.py), on tests/test_torch_genb_apps.py's tiny world
(its files, loaders and engines).

- TPEOptimizer: the same suggestions as JAX's for the same seed and
  observations over 24 trials of each space (the committed sweep YAMLs and
  one with log-uniform and constant dimensions), and the same errors;
- run_eval and run_sweep (random, and bayes over
  configs/sweep_bayes_01.yaml's space with top-p pinned at 0.01, which
  pins the sampled token: the two packages' random draws differ): the same
  captions and trials, the scores within 1e-5;
- prepare_human_eval, plain and multi-filter: params.json and the CSV rows
  equal to JAX's except the uuid file names, the scores within 1e-5, the
  blinded split n // 2;
- the CLIs' JAX behaviours pinned in both packages: human_eval's default
  mode raises KeyError (no RN50x64 ranker is loaded), its multi-filter
  KeyError on the captioner's modules, its refusal of an existing output
  folder, and its plots; the sweep's KeyError at its first ITC trial, and
  its trials over the same space with the mode pinned to CLIP-ViT-L;
- one Gumbel step's ITC, gradient and Adam update against JAX's
  value_and_grad and optax.adam with the same noise (1e-5), a whole run fed
  JAX's draws against JAX's optimize_caption, and a run of the port's own
  draws as tests/test_aux_tools.py runs JAX's.
"""

import csv
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from clipcap_tpu.cli import human_eval as JHE
from clipcap_tpu.cli import sweep as JSW
from clipcap_tpu.core import config as JC
from clipcap_tpu.models import blip_retrieval as JBR
from clipcap_tpu.tools import gumbel_caption_opt as JGO
from clipcap_tpu.utils import tpe as JTPE
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.cli import human_eval, sweep
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models import blip_retrieval as TBR
from clipcap_tpu_torch.tools import gumbel_caption_opt as TGO
from clipcap_tpu_torch.utils import tpe as TTPE

from test_torch_genb_apps import (_one_torch_thread_and_tiny_variants, BLIP_TEXT,  # noqa: F401
                                  BLIP_VIT, VOCAB, engines, world)

ROOT = Path(__file__).resolve().parents[1]
SWEEP_YAML = ROOT / "configs" / "sweep_bayes_01.yaml"
PINNED = {"value": 0.01}  # top-p: the kept set is the top token


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- TPE -----------------------------------------------------------------------------

MIXED = {"lr": {"min": 1e-5, "max": 1e-2, "distribution": "log_uniform_values"},
         "top_p": {"min": 0.1, "max": 0.9}, "min_len": {"min": 5, "max": 30},
         "mode": {"values": ["ITM", "ITC", "CLIP-ViT-L"]}, "batch_size": {"value": 40}}


def _objective(p: dict, t: int) -> float:
    """A deterministic score of a trial's parameters (NaN at trial 7: dropped)."""
    if t == 7:
        return float("nan")
    num = sum(float(v) for v in p.values() if isinstance(v, (int, float)))
    return float(np.sin(num) + 0.1 * len(str(p.get("mode", ""))))


@pytest.mark.parametrize("space", ["sweep_bayes_01", "sweep_bayes_02", "mixed"])
@pytest.mark.parametrize("maximize", [True, False])
def test_tpe_matches_jax(space, maximize):
    params = (MIXED if space == "mixed"
              else yaml.safe_load((ROOT / "configs" / f"{space}.yaml").read_text())["parameters"])
    seed = len(space)
    a = JTPE.TPEOptimizer(params, seed=seed, maximize=maximize)
    b = TTPE.TPEOptimizer(params, seed=seed, maximize=maximize)
    for t in range(24):
        pa, pb = a.suggest(), b.suggest()
        assert pa == pb, t
        a.observe(pa, _objective(pa, t))
        b.observe(pb, _objective(pb, t))
    assert len(b.trials) == 23 and b.best() == a.best()


def test_tpe_errors_and_empty_best_match_jax():
    for mod in (JTPE, TTPE):
        with pytest.raises(ValueError, match="unsupported parameter spec for 'x'"):
            mod.TPEOptimizer({"x": {"distribution": "uniform"}})
    for maximize in (True, False):
        assert (TTPE.TPEOptimizer(MIXED, maximize=maximize).best()
                == JTPE.TPEOptimizer(MIXED, maximize=maximize).best())


# --- the sweep -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def coco(world):
    """Four seeded JPEGs with five captions each, in COCO's json layout."""
    from PIL import Image

    d = world / "coco"
    (d / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    words = VOCAB[5:-2]
    images, annotations = [], []
    for i in range(4):
        name = f"img{i:03d}.jpg"
        Image.fromarray(rng.integers(0, 255, (36 + 4 * i, 40, 3), dtype=np.uint8)).save(
            d / "images" / name)
        images.append({"id": i, "file_name": name})
        for j in range(5):
            caption = " ".join(rng.choice(words, size=int(rng.integers(3, 7)))) + "."
            annotations.append({"image_id": i, "id": 5 * i + j, "caption": caption})
    (d / "captions.json").write_text(json.dumps({"images": images, "annotations": annotations}))
    return str(d / "captions.json"), str(d / "images")


def _capture(monkeypatch):
    """Record what each package's run_eval hands generate_scores."""
    seen = {"jax": [], "port": []}
    for key, mod in (("jax", JSW), ("port", sweep)):
        real = mod.generate_scores

        def spy(gts, res, real=real, key=key):
            seen[key].append((gts, res))
            return real(gts, res)

        monkeypatch.setattr(mod, "generate_scores", spy)
    return seen


def _same_scores(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["CLIP-ViT-L", "ITC"])
def test_run_eval_matches_jax(engines, coco, monkeypatch, mode):
    jeng, teng, _ = engines
    seen = _capture(monkeypatch)
    kw = dict(n=4, mode=mode, batch_size=8, top_p=0.01, max_len=6, manual_seed=3)
    want = JSW.run_eval(jeng, *coco, **kw)
    got = sweep.run_eval(teng, *coco, **kw)
    assert seen["port"] == seen["jax"] and len(seen["port"][0][1]) >= 2
    _same_scores(got, want)
    assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("method", ["random", "bayes"])
def test_run_sweep_matches_jax(engines, coco, monkeypatch, method):
    """Two trials over sweep_bayes_01.yaml's space (modes ITC and
    CLIP-ViT-L, batch sizes 8-64, min length 5-35, top-k, force-eos) with
    top-p pinned; the port's ranker for ITC is the retrieval model."""
    jeng, teng, _ = engines
    cfg = yaml.safe_load(SWEEP_YAML.read_text())
    cfg["method"] = method
    cfg["parameters"]["top_p"] = PINNED
    seen = _capture(monkeypatch)
    kw = dict(trials=2, n_images=2, seed=1)
    want = JSW.run_sweep(jeng, cfg, *coco, **kw)
    got = sweep.run_sweep(teng, cfg, *coco, **kw)
    assert [t for t, _ in got] == [t for t, _ in want]
    assert seen["port"] == seen["jax"]
    for (_, g), (_, w) in zip(got, want):
        _same_scores(g, w)


def _sweep_args(d, coco, *extra):
    return ["--valid_json_path", coco[0], "--image_folder_path", coco[1],
            "--blip_checkpoint", str(d / "blip.pth"), "--blip_vocab", str(d / "vocab.txt"),
            "--clip_vit_l_checkpoint", str(d / "vit_l.pt"), "--clip_merges",
            str(d / "merges.txt"), *extra]


def test_sweep_main_keeps_jax_key_error(world, coco, tmp_path):
    """sweep_bayes_01.yaml's second trial ranks by ITC: JAX's main builds
    its BLIP ranker on the captioner's modules and raises KeyError there,
    and so does the port's. Over the same space with the mode pinned to
    CLIP-ViT-L both mains run the two trials, and the port's returns them
    with finite Bleu_1-4 and CIDEr."""
    args = _sweep_args(world, coco, "--sweep_yaml", str(SWEEP_YAML), "--trials", "2", "--n", "1")
    with pytest.raises(KeyError, match="vision_proj"):
        JSW.main(args)
    with pytest.raises(KeyError, match="vision_proj"):
        sweep.main(args + ["--device", "cpu"])
    cfg = yaml.safe_load(SWEEP_YAML.read_text())
    cfg["parameters"]["mode"] = {"values": ["CLIP-ViT-L"]}
    pinned = tmp_path / "sweep_clip_l.yaml"
    pinned.write_text(yaml.safe_dump(cfg, sort_keys=False))
    args = _sweep_args(world, coco, "--sweep_yaml", str(pinned), "--trials", "2", "--n", "1")
    JSW.main(args)
    results = sweep.main(args + ["--device", "cpu"])
    assert len(results) == 2 and {t["mode"] for t, _ in results} == {"CLIP-ViT-L"}
    for _, scores in results:
        assert all(np.isfinite(scores[k]) for k in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                                                    "CIDEr"))


# --- human-eval preparation ----------------------------------------------------------


def _rows(path: Path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _records(out: Path):
    recs = json.loads((out / "params.json").read_text())
    for r in recs["captions"]:
        assert (out / r.pop("file_name")).is_file()
    return recs


@pytest.mark.parametrize("multi_filter", [False, True], ids=["plain", "multi_filter"])
def test_prepare_human_eval_matches_jax(engines, coco, tmp_path, multi_filter):
    jeng, teng, _ = engines
    kw = dict(n=4, mode="CLIP-ViT-L", multi_filter=multi_filter, set_top_p=0.01, set_max_len=8,
              manual_seed=5, make_plots=False)
    JHE.prepare_human_eval(jeng, *coco, str(tmp_path / "jax"), **kw)
    human_eval.prepare_human_eval(teng, *coco, str(tmp_path / "port"), **kw)
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert got["args"] == want["args"] and len(got["captions"]) == 4
    score_keys = ("synth_captions_scores_itc", "synth_captions_scores_clipl")
    for g, w in zip(got["captions"], want["captions"]):
        for k in score_keys:
            if k in w:
                np.testing.assert_allclose(g.pop(k), w.pop(k), rtol=1e-5, atol=1e-5)
        g["original_file_name"] = w["original_file_name"] = Path(g["original_file_name"]).name
        assert g == w
    if multi_filter:
        assert not (tmp_path / "port" / "eval.csv").exists()
        return
    for name, col in (("eval.csv", 1), ("gt.csv", 1)):
        a, b = _rows(tmp_path / "port" / name), _rows(tmp_path / "jax" / name)
        assert len(a) == 5
        for ra, rb in zip(a[1:], b[1:]):
            del ra[col], rb[col]  # the uuid file names
            if name == "gt.csv":
                ra[-1], rb[-1] = Path(ra[-1]).name, Path(rb[-1]).name
            assert ra == rb
    gt = _rows(tmp_path / "port" / "gt.csv")[1:]
    assert sum(r[2] == "True" for r in gt) == 4 // 2  # the blinded split


def _human_eval_args(d, coco, out, *extra):
    return ["--valid_json_path", coco[0], "--image_folder_path", coco[1], "--output_folder",
            str(out), "--n", "2", "--set_max_len", "4", "--blip_checkpoint", str(d / "blip.pth"),
            "--blip_vocab", str(d / "vocab.txt"), "--clip_vit_l_checkpoint", str(d / "vit_l.pt"),
            "--clip_merges", str(d / "merges.txt"), *extra]


def test_human_eval_main_keeps_jax_behaviours(world, coco, tmp_path):
    """In both packages: the default mode raises KeyError (main loads no
    RN50x64 ranker), --multi_filter's ITM stage raises KeyError on the
    captioner's modules, main plots the winners' scores, and a rerun into
    the same folder is refused."""
    for tag, main, extra in (("jax", JHE.main, []), ("port", human_eval.main, ["--device", "cpu"])):
        with pytest.raises(KeyError, match="RN50x64"):
            main(_human_eval_args(world, coco, tmp_path / f"{tag}_default", *extra))
        with pytest.raises(KeyError, match="itm_head"):
            main(_human_eval_args(world, coco, tmp_path / f"{tag}_mf", "--multi_filter", *extra))
        out = tmp_path / f"{tag}_plain"
        args = _human_eval_args(world, coco, out, "--mode", "CLIP-ViT-L", *extra)
        main(args)
        for suffix in ("all.png", "all.svg", "winner.png", "winner.svg"):
            assert (out / f"score_CLIP-ViT-L_hist_{suffix}").is_file(), (tag, suffix)
        assert len(_rows(out / "eval.csv")) == 3
        with pytest.raises(FileExistsError):
            main(args)


# --- Gumbel caption optimization -----------------------------------------------------

G_VOCAB = "[PAD] [UNK] [CLS] [SEP] a b c d e f g h".split()
G_TEXT = dict(vocab_size=len(G_VOCAB), hidden_size=16, num_layers=1, num_heads=2,
              intermediate_size=32, max_position_embeddings=16, encoder_width=16, embed_dim=8)
G_VIT = dict(image_size=16, patch_size=8, width=16, layers=1, heads=2, output_dim=None,
             style="blip")
G_LEN = 4


@pytest.fixture(scope="module")
def gumbel_world(tmp_path_factory):
    """tests/test_aux_tools.py's retrieval model and image (JAX's init),
    converted to the port, and the tokenizers of both packages."""
    from clipcap_tpu.tokenizers.wordpiece import WordPieceTokenizer as JWP
    from clipcap_tpu_torch.tokenizers.wordpiece import WordPieceTokenizer as TWP

    d = tmp_path_factory.mktemp("gumbel")
    (d / "vocab.txt").write_text("\n".join(G_VOCAB))
    jv, jt = JC.ViTConfig(**G_VIT), JC.BlipTextConfig(**G_TEXT)
    params = JBR.init(jax.random.PRNGKey(0), jv, jt)
    img = JBR.encode_image(params, jv, jax.random.normal(jax.random.PRNGKey(1), (1, 3, 16, 16)))
    model = convert.load(TBR.BlipRetrieval(TC.ViTConfig(**G_VIT), TC.BlipTextConfig(**G_TEXT),
                                           device="cpu"),
                         convert.blip_retrieval_state_dict(_np(params)))
    return (params, jt, img, JWP.from_vocab_file(str(d / "vocab.txt")), model,
            TC.BlipTextConfig(**G_TEXT), torch.from_numpy(np.array(img)),
            TWP.from_vocab_file(str(d / "vocab.txt")))


def _jax_step(params, jt, img, tok, tx):
    """JAX's jitted step of optimize_caption with the Gumbel noise injected:
    the same loss through JAX's _soft_text_hidden, value_and_grad and
    optax's update."""
    import optax

    feat = img[:, 0] @ params["vision_proj"]["w"] + params["vision_proj"]["b"]
    feat = feat / jnp.linalg.norm(feat, axis=-1, keepdims=True)
    vocab = jt.vocab_size

    def loss_fn(lg, g, tau):
        y = jax.nn.softmax((lg + g) / tau, axis=-1)
        y_hard = jax.nn.one_hot(jnp.argmax(y, axis=-1), vocab, dtype=y.dtype)
        soft = y_hard + y - jax.lax.stop_gradient(y)
        frame = jnp.concatenate([jax.nn.one_hot(jnp.full((1, 1), tok.cls_token_id), vocab), soft,
                                 jax.nn.one_hot(jnp.full((1, 1), tok.sep_token_id), vocab)], 1)
        hidden = JGO._soft_text_hidden(params["text"], jt, frame)
        txt = hidden[:, 0] @ params["text_proj"]["w"] + params["text_proj"]["b"]
        txt = txt / jnp.linalg.norm(txt, axis=-1, keepdims=True)
        return -jnp.sum(feat * txt)

    @jax.jit
    def step(lg, state, g, tau):
        loss, grad = jax.value_and_grad(loss_fn)(lg, g, tau)
        updates, state = tx.update(grad, state)
        return optax.apply_updates(lg, updates), state, -loss, grad

    return step


def test_gumbel_step_matches_jax(gumbel_world):
    """Three steps from the same logits with the same noise: the ITC, its
    gradient (rtol 1e-5, atol 1e-6) and the Adam-updated logits (1e-5)
    each step."""
    import optax

    params, jt, img, jtok, model, tt, timg, ttok = gumbel_world
    rng = np.random.default_rng(4)
    logits = (0.01 * rng.standard_normal((1, G_LEN, jt.vocab_size))).astype(np.float32)
    tx = optax.adam(0.3)
    jstep, jstate, jl = _jax_step(params, jt, img, jtok, tx), tx.init(jnp.asarray(logits)), \
        jnp.asarray(logits)
    feat = TGO.image_feature(model, timg)
    opt = TGO.AdamW(lambda count: 0.3, 0.0, ["logits"])
    tl = torch.from_numpy(logits.copy())
    state = opt.init([tl])
    for i, tau in enumerate((1.0, 0.5, 0.1)):
        g = rng.gumbel(size=logits.shape).astype(np.float32)
        jl, jstate, jitc, jgrad = jstep(jl, jstate, jnp.asarray(g), jnp.float32(tau))
        itc, grad, state = TGO.gumbel_step(model, feat, tl, opt, state, torch.from_numpy(g), tau,
                                           ttok.cls_token_id, ttok.sep_token_id)
        np.testing.assert_allclose(float(itc), float(jitc), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6,
                                   err_msg=f"gradient, step {i}")
        # Adam's first steps move each logit by ~lr g / (|g| + eps): a
        # gradient near eps carries its rounding into the update
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5,
                                   err_msg=f"logits after Adam, step {i}")


def _jax_draws(seed: int, steps: int, shape):
    """optimize_caption's draws: the initial logits from PRNGKey(seed), then
    each step's Gumbel noise from rng, sub = split(rng)."""
    rng = jax.random.PRNGKey(seed)
    init = np.array(0.01 * jax.random.normal(rng, shape))
    noise = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        noise.append(np.array(jax.random.gumbel(sub, shape, dtype=jnp.float32)))
    return torch.from_numpy(init), torch.from_numpy(np.stack(noise))


def test_optimize_caption_with_jax_draws_matches_jax(gumbel_world):
    params, jt, img, jtok, model, tt, timg, ttok = gumbel_world
    kw = dict(caption_length=G_LEN, steps=8, lr=0.3, seed=2, log_every=0)
    want = JGO.optimize_caption(params, jt, img, jtok, **kw)
    init, noise = _jax_draws(2, 8, (1, G_LEN, jt.vocab_size))
    got = TGO.optimize_caption(model, tt, timg, ttok, init_logits=init, gumbel_noise=noise,
                               device="cpu", **kw)
    assert got["tokens"] == want["tokens"] and got["caption"] == want["caption"]
    np.testing.assert_allclose(got["itc"], want["itc"], rtol=1e-4, atol=1e-5)


def test_optimize_caption_runs_with_its_own_draws(gumbel_world, capsys):
    """tests/test_aux_tools.py's run of JAX's optimize_caption, in the port:
    a caption of 4 tokens and a finite ITC; the log lines as JAX prints them."""
    *_, model, tt, timg, ttok = gumbel_world
    out = TGO.optimize_caption(model, tt, timg, ttok, caption_length=G_LEN, steps=60, lr=0.3,
                               log_every=30, device="cpu")
    assert isinstance(out["caption"], str) and len(out["tokens"]) == G_LEN
    assert np.isfinite(out["itc"]) and -1.0 <= out["itc"] <= 1.0
    logged = [x for x in capsys.readouterr().out.splitlines() if x.startswith("step ")]
    assert [x.split(":")[0] for x in logged] == ["step 0", "step 30", "step 59"]
    with pytest.raises(ValueError, match="asked for cuda"):
        TGO.optimize_caption(model, tt, timg, ttok, steps=1)  # the card unless asked for the CPU
