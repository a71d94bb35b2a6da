"""GPT-2, GPT-J and T5 tokenizer wrappers with the reference's
`encode_text` semantics (port of GPT2TokenizerWrapper,
GPTJTokenizerWrapper, T5TokenizerWrapper and create_tokenizer,
clipcap_tpu/tokenizers/api.py).

encode_text (reference lms/GPT2.py:28-44): a given max_token_length is
extended by one per requested special token before truncation, then BOS is
prepended / EOS appended, so a capped caption keeps its specials.
bos == eos == the endoftext token. GPT-J's wrapper truncates only unless
asked for the specials. T5's truncates only (reference lms/T0.py:26-30)
and, as JAX's, takes no add_bos/add_eos.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

from .bpe import ByteLevelBPE

GPT2_EOT = "<|endoftext|>"


class GPT2TokenizerWrapper:
    def __init__(self, bpe: ByteLevelBPE, eot_token: str = GPT2_EOT):
        self.bpe = bpe
        if eot_token in bpe.encoder:
            self.bos_token_id = bpe.encoder[eot_token]
            self.eos_token_id = bpe.encoder[eot_token]
        else:  # tiny test vocabs
            self.bos_token_id = bpe.vocab_size - 1
            self.eos_token_id = bpe.vocab_size - 1
        self.all_special_ids = sorted({self.bos_token_id, self.eos_token_id})

    @classmethod
    def create(cls, vocab_dir: str) -> "GPT2TokenizerWrapper":
        return cls(ByteLevelBPE.from_pretrained_dir(vocab_dir))

    def encode(self, text: str) -> List[int]:
        return self.bpe.encode(text)

    def encode_text(
        self,
        text: str,
        max_token_length: Optional[int] = None,
        add_bos: bool = False,
        add_eos: bool = False,
    ) -> List[int]:
        if max_token_length is not None:
            if add_bos:
                max_token_length += 1
            if add_eos:
                max_token_length += 1
        tokens = self.encode(text)
        if max_token_length is not None:
            tokens = tokens[:max_token_length]
        if add_bos:
            tokens = [self.bos_token_id] + tokens
        if add_eos:
            tokens = tokens + [self.eos_token_id]
        return tokens

    def decode_tokens(self, tokens: Sequence[int]) -> str:
        return self.bpe.decode(tokens)

    @property
    def vocab_size(self) -> int:
        return self.bpe.vocab_size


class GPTJTokenizerWrapper(GPT2TokenizerWrapper):
    """GPT-J shares GPT-2's BPE; by default its encode_text truncates only
    (no special tokens added), as JAX's does. Ids from 50257 up (GPT-J's
    padding rows) decode to nothing, as the BPE decoder drops ids it does
    not know.

    Unlike JAX's wrapper, encode_text also takes add_bos/add_eos (GPT-2's
    semantics): the COCO validator asks for them to score the validation
    loss, and JAX's GPT-J wrapper refuses them, so JAX's cli.evaluate
    raises TypeError on a GPT-J checkpoint (ROADMAP.md §3)."""


class T5TokenizerWrapper:
    """T5/T0 tokenizer backed by a local HF `tokenizer.json` (SentencePiece
    vocabularies are pretrained files; pass the directory holding it, and
    nothing is downloaded). The decoder starts from the pad id, so
    bos_token_id is pad's. encode_text truncates only: like JAX's, it takes
    no add_bos/add_eos, so the COCO validator's validation loss, which asks
    for them, raises TypeError on a T5 checkpoint in both packages."""

    def __init__(self, hf_tokenizer):
        self.tk = hf_tokenizer
        self.eos_token_id = self.tk.token_to_id("</s>")
        self.pad_token_id = self.tk.token_to_id("<pad>")
        self.bos_token_id = self.pad_token_id
        specials = [self.eos_token_id, self.pad_token_id, self.tk.token_to_id("<unk>")]
        self.all_special_ids = sorted({s for s in specials if s is not None})

    @classmethod
    def create(cls, vocab_dir: str) -> "T5TokenizerWrapper":
        from tokenizers import Tokenizer

        path = Path(vocab_dir) / "tokenizer.json"
        if not path.exists():
            raise FileNotFoundError(
                f"T5 tokenizer needs a local {path} (SentencePiece assets are pretrained "
                "files; nothing is downloaded)")
        return cls(Tokenizer.from_file(str(path)))

    def encode(self, text: str) -> List[int]:
        return self.tk.encode(text).ids

    def encode_text(self, text: str, max_token_length: Optional[int] = None) -> List[int]:
        tokens = self.encode(text)
        if max_token_length is not None:
            tokens = tokens[:max_token_length]
        return tokens

    def decode_tokens(self, tokens: Sequence[int]) -> str:
        return self.tk.decode([int(t) for t in tokens])

    @property
    def vocab_size(self) -> int:
        return self.tk.get_vocab_size()


def create_tokenizer(tokenizer_model_type: str, vocab_dir: str):
    """Type string -> tokenizer wrapper (reference create_dataset.py:242-255)."""
    t = tokenizer_model_type.lower()
    if t == "gpt2":
        return GPT2TokenizerWrapper.create(vocab_dir)
    if t in ("gptj", "gpt-j"):
        return GPTJTokenizerWrapper.create(vocab_dir)
    if t in ("t5", "t0"):
        return T5TokenizerWrapper.create(vocab_dir)
    if t in ("deepseek_v3", "deepseek-v3", "moonlight"):
        # Moonlight's tokenizer is tiktoken's, with a pre-tokenizer of its
        # own: GPT-2's byte-level BPE over its ranks would give other ids
        raise NotImplementedError(
            f"no tokenizer for {tokenizer_model_type!r}: Moonlight's tiktoken tokenizer is not "
            "ported (serving reads token ids only)")
    raise ValueError(
        f"invalid tokenizer model type: {tokenizer_model_type!r} (expected gpt2/gpt-j/t0/t5)")
