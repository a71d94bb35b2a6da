"""The port's host preprocessing and caption metrics against the JAX
package: clip_preprocess, blip_preprocess and clip_preprocess_u8 are
bit-equal on PIL images of several sizes and aspect ratios, and the
port's copies of the metric files give the JAX scores (generate_scores,
generate_scores_full with and without SPICE, each scorer alone)."""

import numpy as np
import pytest

from clipcap_tpu.data import preprocessing as JP
from clipcap_tpu.eval import bleu as JBLEU
from clipcap_tpu.eval import cider as JCIDER
from clipcap_tpu.eval import meteor as JMETEOR
from clipcap_tpu.eval import ptb_tokenizer as JPTB
from clipcap_tpu.eval import rouge as JROUGE
from clipcap_tpu.eval import scoring as JSCORING
from clipcap_tpu.eval import spice as JSPICE
from clipcap_tpu_torch.data import preprocessing as TP
from clipcap_tpu_torch.eval import bleu, cider, meteor, ptb_tokenizer, rouge, scoring, spice

SIZES = [(40, 40), (64, 33), (17, 90), (300, 200), (224, 224)]


def _image(w, h, seed):
    from PIL import Image

    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3),
                                                                 dtype=np.uint8))


@pytest.mark.parametrize("size", SIZES)
def test_preprocessing_bit_equal(size):
    img = _image(*size, seed=size[0])
    for fn, kw in ((TP.clip_preprocess, dict(image_size=32)),
                   (TP.clip_preprocess, dict(image_size=32, do_normalize=False)),
                   (TP.blip_preprocess, dict(image_size=48)),
                   (TP.clip_preprocess_u8, dict(image_size=24))):
        got, want = fn(img, **kw), getattr(JP, fn.__name__)(img, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TP.CLIP_MEAN, JP.CLIP_MEAN)
    np.testing.assert_array_equal(TP.CLIP_STD, JP.CLIP_STD)


GTS = {
    1: ["a man riding a wave on a surfboard", "a surfer rides a big wave",
        "man surfing on the ocean", "a person on a surfboard rides a wave"],
    2: ["a cat sitting on a wooden bench", "a cat sits on the bench outside",
        "small cat resting on a park bench", "a kitten on a wooden seat"],
    3: ["Two dogs play in the green park.", "A DOG runs, and another one follows!"],
}
RES = {1: ["a man on a beach"], 2: ["a cat sitting on a wooden bench"],
       3: ["two dogs playing on the grass"]}


def _wrap(d):
    return {k: [{"caption": c} for c in v] for k, v in d.items()}


@pytest.mark.parametrize("entry", ["generate_scores", "full", "full_without_spice"])
def test_generate_scores_match_jax(entry):
    gts, res = _wrap(GTS), _wrap(RES)
    if entry == "generate_scores":
        got, want = scoring.generate_scores(gts, res), JSCORING.generate_scores(gts, res)
    else:
        kw = dict(include_spice=entry == "full")
        got = scoring.generate_scores_full(gts, res, **kw)
        want = JSCORING.generate_scores_full(gts, res, **kw)
    assert got == want
    assert ("SPICE" in got[0]) == (entry == "full")


def test_each_metric_matches_jax():
    gts, res = JPTB.ptb_tokenize(_wrap(GTS)), JPTB.ptb_tokenize(_wrap(RES))
    assert ptb_tokenizer.ptb_tokenize(_wrap(GTS)) == gts
    assert bleu.bleu(gts, res) == JBLEU.bleu(gts, res)
    assert cider.cider_d(gts, res) == JCIDER.cider_d(gts, res)
    assert rouge.rouge_l(gts, res) == JROUGE.rouge_l(gts, res)
    assert meteor.meteor(gts, res) == JMETEOR.meteor(gts, res)
    assert spice.spice(gts, res) == JSPICE.spice(gts, res)
