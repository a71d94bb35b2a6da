"""CLIP's BPE tokenizer (end-of-word `</w>` variant), pure Python: a copy
of clipcap_tpu/tokenizers/clip_bpe.py with `regex` imported only when a
tokenizer is built, so that the rest of the port imports without it.

Equivalent of `clip.tokenize`, which the reference calls for ranking and
scoring (reference sampling.py:29, evaluate_model.py:352). Loads the
standard `bpe_simple_vocab_16e6.txt.gz` merges file from a local path
(gzip or plain text). Text cleaning applies html-unescape, whitespace
normalisation and lowercase (the original also runs ftfy's mojibake
fixing; for well-formed UTF-8 captions the outputs are identical).
"""

from __future__ import annotations

import gzip
import html
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from .bpe import bytes_to_unicode

CONTEXT_LENGTH = 77
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"

_PAT = r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""


class CLIPTokenizer:
    def __init__(self, merges: List[tuple]):
        import regex

        self._pat = regex.compile(_PAT, regex.IGNORECASE)
        self._space = regex.compile(r"\s+")
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend([SOT, EOT])
        self.encoder: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot_token = self.encoder[SOT]
        self.eot_token = self.encoder[EOT]
        self._cache = {SOT: SOT, EOT: EOT}

    @classmethod
    def from_merges_file(cls, path: str, num_merges: int = 48894) -> "CLIPTokenizer":
        p = Path(path)
        opener = gzip.open if p.suffix == ".gz" else open
        with opener(p, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # the standard file: a version header, then the merges
        merges = [tuple(line.split()) for line in lines[1: num_merges + 1] if line]
        return cls(merges)

    def _clean(self, text: str) -> str:
        text = html.unescape(html.unescape(text))
        return self._space.sub(" ", text).strip().lower()

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            self._cache[token] = word[0]
            return word[0]

        def get_pairs(w):
            return {(w[i], w[i + 1]) for i in range(len(w) - 1)}

        pairs = get_pairs(word)
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in self._pat.findall(self._clean(text)):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(self, texts, context_length: int = CONTEXT_LENGTH,
                 truncate: bool = False) -> np.ndarray:
        """clip.tokenize semantics: [sot] ids [eot], zero-padded [B, 77] int32."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length {context_length}")
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token
            result[i, : len(tokens)] = tokens
        return result
