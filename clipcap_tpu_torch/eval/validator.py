"""Validation-time caption quality (port of clipcap_tpu/eval/validator.py:
the reference's CaptionValidator protocol, model.py:14-23, and
CocoCaptionValidator, evaluate_model.py:422-535).

Per chunk of images: every sampler captions each image (one sample_batch
call per chunk for samplers that have one, else image by image), the
captions are scored against the image by CLIP, and the validation CE loss
re-runs the captioner over the ground-truth captions. get_results runs
the caption metrics per sampler and the mean loss and CLIP score.

The ground-truth tokens are zero-padded, so the attention mask is all
ones and padding drops out only through ignore_index 0 (the reference
quirk at evaluate_model.py:503-510, kept).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .scoring import generate_scores


class CaptionValidator:
    """Protocol (reference model.py:14-23)."""

    def process(self, bundle, batch):
        pass

    def reset(self):
        pass

    def get_results(self):
        pass

    def load_image_by_id(self, image_id):
        pass


class CocoCaptionValidator(CaptionValidator):
    def __init__(self, dataset, preprocess, caption_samplers: Dict[str, object],
                 clip_scoring, batched_sampling: bool = True):
        """dataset: data.coco.CocoImageDataset-like (get_index,
        load_image_by_id); preprocess: PIL image -> [3, H, W] array for the
        captioner's visual encoder; caption_samplers: {id: sampler};
        clip_scoring: eval.clip_scoring.ClipScoring.

        batched_sampling: samplers with a sample_batch run once per
        process() chunk instead of once per image. Per-image captions are
        the same for beam and clip-guided; the no-beam sweep's sampled rows
        match in distribution only (a row's random draws depend on its
        index in the batch). False gives image-at-a-time trajectories."""
        self.dataset = dataset
        self.preprocess = preprocess
        self.caption_samplers = caption_samplers
        self.clip_scoring = clip_scoring
        self.batched_sampling = batched_sampling
        self.gt_captions_by_image_id = dataset.get_index().get_captions_by_image_id()
        self.reset()

    def reset(self):
        self.ground_truth_captions = {}
        self.caption_hypo = {sid: {} for sid in self.caption_samplers}
        self.results = {"captions": []}
        self.losses: List[float] = []
        self.clip_scores: List[float] = []

    def process(self, bundle, batch):
        batch = [x for x in batch if x is not None]
        images = [item["image"] for item in batch]
        image_tensors = [np.asarray(self.preprocess(img)) for img in images]
        image_captions_gt = []

        pre: Dict[str, List[List[str]]] = {}
        if self.batched_sampling and len(batch) > 1:
            stacked = np.stack(image_tensors, axis=0)
            for sampler_id, sampler in self.caption_samplers.items():
                fn = getattr(sampler, "sample_batch", None)
                if fn is not None:
                    pre[sampler_id] = fn(bundle, stacked, images)

        for idx, item in enumerate(batch):
            image_entry = item["image_entry"]
            image = images[idx]
            gt = self.gt_captions_by_image_id[image_entry.id]
            self.ground_truth_captions[image_entry.id] = [{"caption": c} for c in gt]
            image_captions_gt.append(gt)

            sampling_results = []
            for sampler_id, sampler in self.caption_samplers.items():
                if sampler_id in pre:
                    captions = pre[sampler_id][idx]
                else:
                    captions = sampler.sample(bundle, image_tensors[idx], image)
                self.caption_hypo[sampler_id][image_entry.id] = [{"caption": captions[0]}]
                # the scores of all of an image's captions in one copy to the host
                clip_scores = self.clip_scoring.score_image(image, captions).cpu().numpy()
                captions_result = []
                for i, c in enumerate(captions):
                    cs = float(clip_scores[0, i])
                    captions_result.append({"caption": c, "clip_score": cs, "gt": gt[0]})
                    self.clip_scores.append(cs)
                sampling_results.append({"sampler_id": sampler_id, "captions": captions_result})

            self.results["captions"].append({
                "image_id": image_entry.id,
                "image_url": image_entry.url,
                "sampling_results": sampling_results,
            })

        self.losses.extend(self.caption_losses(bundle, np.stack(image_tensors, axis=0),
                                               image_captions_gt))

    @staticmethod
    def caption_losses(bundle, image_tensors: np.ndarray, captions_gt) -> List[float]:
        """The validation CE loss over ground-truth captions (reference
        :497-516): one loss per caption round i < the fewest captions of an
        image, each over the i-th caption of every image, zero-padded."""
        with torch.no_grad():
            prefixes = bundle.encode_image(torch.from_numpy(image_tensors))
            losses = []
            for i in range(min(len(x) for x in captions_gt)):
                encoded = [bundle.tokenizer.encode_text(c[i], add_bos=True, add_eos=True)
                           for c in captions_gt]
                tokens = np.zeros((len(encoded), max(len(t) for t in encoded)), np.int64)
                for j, t in enumerate(encoded):
                    tokens[j, : len(t)] = t
                loss, _ = bundle.model.caption_loss(
                    torch.from_numpy(tokens).to(bundle.device), prefixes)
                losses.append(loss)
            return torch.stack(losses).cpu().tolist() if losses else []

    def get_results(self):
        results = self.results
        sampler_scores = {}
        for sampler_id, hypo in self.caption_hypo.items():
            gts = {k: self.ground_truth_captions[k] for k in hypo}
            scores, _ = generate_scores(gts, hypo)
            sampler_scores[sampler_id] = scores
        results["validation_loss"] = float(np.mean(self.losses)) if self.losses else float("nan")
        results["clip_score"] = (float(np.mean(self.clip_scores)) if self.clip_scores
                                 else float("nan"))
        results["sampler_scores"] = sampler_scores
        return results

    def load_image_by_id(self, image_id):
        return self.dataset.load_image_by_id(image_id)
