"""Seeded weights and inputs, made on the card from `--seed` in a few large
draws, in the type they are served in.

`captioner_layout(config)` lists every tensor of a captioner as (name,
shape, kind, value) in the port's state-dict names; `make(layout, seed)`
fills them from one stream of normal draws taken in chunks of 2**28. The
benchmark hands the same tensors to the program (`load_state_dict`) and,
drawn again after the window, to the reference, which reads nothing the
program made.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

CHUNK = 1 << 28  # elements per draw (1 GiB of f32)

Leaf = Tuple[str, Tuple[int, ...], str, float]  # name, shape, "normal" | "const", std | value


def _mapper_layout(m: dict, prefix: str = "mapper.") -> List[Leaf]:
    d, c = m["dim_embedding"], m["dim_clip"]
    hidden = int(d * m["mlp_ratio"])

    def torch_default(fan_in):  # nn.Linear's U(+-1/sqrt(fan_in)) has this std
        return 1.0 / math.sqrt(3 * fan_in)

    out = [(prefix + "linear.weight", (m["clip_length"] * d, c), "normal", torch_default(c)),
           (prefix + "linear.bias", (m["clip_length"] * d,), "normal", torch_default(c)),
           (prefix + "prefix_const", (m["prefix_length"], d), "normal", m["prefix_init_std"])]
    for i in range(m["num_layers"]):
        p = f"{prefix}layers.{i}."
        out += [(p + "ln1.weight", (d,), "const", 1.0), (p + "ln1.bias", (d,), "const", 0.0),
                (p + "wq.weight", (d, d), "normal", torch_default(d)),
                (p + "wkv.weight", (2 * d, d), "normal", torch_default(d)),
                (p + "wo.weight", (d, d), "normal", torch_default(d)),
                (p + "wo.bias", (d,), "normal", torch_default(d)),
                (p + "ln2.weight", (d,), "const", 1.0), (p + "ln2.bias", (d,), "const", 0.0),
                (p + "fc1.weight", (hidden, d), "normal", torch_default(d)),
                (p + "fc1.bias", (hidden,), "normal", torch_default(d)),
                (p + "fc2.weight", (d, hidden), "normal", torch_default(hidden)),
                (p + "fc2.bias", (d,), "normal", torch_default(hidden))]
    return out


def captioner_layout(config: dict) -> List[Leaf]:
    """Every tensor of the configuration's captioner, in a fixed order: the
    mapper, the LM of the configuration's family
    (benchmark/families/<family>.py `layout`) and the ViT if it has one."""
    import importlib

    family = importlib.import_module(f"benchmark.families.{config['family']}")
    out = _mapper_layout(config["mapper"]) + family.layout(config)
    if "visual" in config:
        out += _vit_layout(config["visual"])
    return out


def make(layout: List[Leaf], seed: int, device, dtype) -> Dict[str, "object"]:
    """The layout's tensors on `device` in `dtype`: normal leaves are slices
    of one seeded stream of N(0, 1) draws, scaled by their std."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    buf, used = None, 0
    for name, shape, kind, value in layout:
        n = math.prod(shape)
        if kind == "const":
            out[name] = torch.full(shape, value, dtype=dtype, device=device)
            continue
        if buf is None or used + n > buf.numel():
            buf = torch.randn(max(CHUNK, n), generator=gen, device=device)
            used = 0
        out[name] = (buf[used: used + n].view(shape) * value).to(dtype)
        used += n
    return out


def clip_features(n: int, width: int, seed: int, device):
    """[n, width] f32 N(0, 1) stand-ins for CLIP's pooled image features."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    return torch.randn(n, width, generator=gen, device=device)


def _vit_layout(v: dict, prefix: str = "visual.") -> List[Leaf]:
    d, p = v["width"], v["patch_size"]
    hidden = int(d * v["mlp_ratio"])
    grid = v["image_size"] // p
    out = [(prefix + "patch.weight", (d, 3 * p * p), "normal", 0.02),
           (prefix + "cls", (d,), "normal", d ** -0.5),
           (prefix + "pos", (grid * grid + 1, d), "normal", d ** -0.5),
           (prefix + "ln_pre.weight", (d,), "const", 1.0),
           (prefix + "ln_pre.bias", (d,), "const", 0.0)]
    for i in range(v["layers"]):
        b = f"{prefix}blocks.{i}."
        out += [(b + "ln1.weight", (d,), "const", 1.0), (b + "ln1.bias", (d,), "const", 0.0),
                (b + "qkv.weight", (3 * d, d), "normal", 0.02),
                (b + "qkv.bias", (3 * d,), "normal", 0.02),
                (b + "out.weight", (d, d), "normal", 0.02), (b + "out.bias", (d,), "normal", 0.02),
                (b + "ln2.weight", (d,), "const", 1.0), (b + "ln2.bias", (d,), "const", 0.0),
                (b + "fc1.weight", (hidden, d), "normal", 0.02),
                (b + "fc1.bias", (hidden,), "normal", 0.02),
                (b + "fc2.weight", (d, hidden), "normal", 0.02),
                (b + "fc2.bias", (d,), "normal", 0.02)]
    out += [(prefix + "ln_post.weight", (d,), "const", 1.0),
            (prefix + "ln_post.bias", (d,), "const", 0.0),
            (prefix + "proj", (d, v["output_dim"]), "normal", d ** -0.5)]
    return out


def pixels(n: int, size: int, seed: int, batch: int, device):
    """[n, 3, size, size] f32 N(0, 1) stand-ins for preprocessed images:
    batch `batch` of the seed's stream."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed) + 2 + 1000 * int(batch))
    return torch.randn(n, 3, size, size, generator=gen, device=device)


def write_gpt2_vocab(folder) -> None:
    """A byte-level BPE vocabulary of GPT-2's size (50,257): the 256 byte
    symbols, 50,000 two-symbol merges and <|endoftext|> last, so "." is id
    13 and <|endoftext|> 50256, as in GPT-2's own files (a frozen copy of
    chip_smoke.py's write_gpt2_vocab, with GPT-2's public byte table)."""
    import json
    from pathlib import Path

    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + \
        list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    base = [chr(c) for c in cs]  # in GPT-2's table order: '!' is 0, '.' is 13
    merges = [(a, b) for a in base for b in base][:50257 - len(base) - 1]
    vocab = {t: i for i, t in enumerate(base + [a + b for a, b in merges] + ["<|endoftext|>"])}
    if len(vocab) != 50257 or vocab["."] != 13:
        raise RuntimeError("synthetic GPT-2 vocabulary malformed")
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "vocab.json").write_text(json.dumps(vocab))
    (folder / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
