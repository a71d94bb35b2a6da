"""Tiny stand-ins of the benchmark's configurations and mixes for CPU
rehearsals: the same files with their sizes cut to a few rows."""

from __future__ import annotations

import copy

from benchmark import run as B


def serving_context(cell: str = "gpt2xl.serve_backlog", seed: int = 12345678901,
                    seconds: float = 2.0, trace: bool = False) -> B.Context:
    """The cell's files with GPT2-XL, the mapper and the mix cut to CPU size."""
    c, config, traffic, limits = B.load_cell(cell)
    config = copy.deepcopy(config)
    config.update(vocab_size=2048, n_positions=128, n_embd=512, n_layer=4, n_head=8)
    # one prefix position: the generated tokens' keys and values then carry
    # enough of each step that a decode step's lost cache write shows
    config["mapper"].update(dim_clip=32, dim_embedding=512, prefix_length=1, clip_length=1,
                            num_layers=1, num_heads=4)
    # logits spread 0.02 x sqrt(512) x 13.5 = 6, as at full size; at this
    # width the 4-bit control's error already reaches the full size's limit
    config["assumed"]["ln_f_gain"] = 13.5
    traffic = copy.deepcopy(traffic)
    traffic.update(slots=8, steps_per_sync=4, pool_rows=64, judge_requests=16, warm_s=0.5,
                   close_slack_s=0.5)
    traffic["caps"].update(mean=6.0, std=2.0, min=2, max=10)
    traffic["settings"].update(max_new_tokens=12, eos_token_id=2047)
    if traffic["arrivals"] == "poisson":
        traffic.update(rate=20.0, trace_s=0.5)
    return B.Context(cell=c, config=config, traffic=traffic, limits=limits, seed=seed,
                     seconds=seconds, trace=trace, device="cpu")


def beam_context(cell: str = "gptj6b.beam_folder", seed: int = 12345678901,
                 seconds: float = 1.0, trace: bool = False) -> B.Context:
    """The beam cell's files with GPT-J, the ViT, the mapper and the mix cut
    to CPU size (the vocabulary stays GPT-2's: the tokenizer needs it)."""
    c, config, traffic, limits = B.load_cell(cell)
    config = copy.deepcopy(config)
    config.update(vocab_size=50400, n_positions=64, n_embd=512, n_layer=4, n_head=8,
                  rotary_dim=16)
    config["mapper"].update(dim_clip=16, dim_embedding=512, prefix_length=2, clip_length=2,
                            num_layers=1, num_heads=4)
    config["visual"].update(image_size=32, patch_size=16, width=32, layers=1, heads=2,
                            output_dim=16)
    # logits spread 0.02 x sqrt(512) x 4.1 = 1.9: at this width the int8
    # control's score error already reaches the full size's limit
    config["assumed"]["ln_f_gain"] = 4.1
    traffic = copy.deepcopy(traffic)
    traffic.update(images=4, batches=2, max_new_tokens=12, judge_images=8)
    return B.Context(cell=c, config=config, traffic=traffic, limits=limits, seed=seed,
                     seconds=seconds, trace=trace, device="cpu")
