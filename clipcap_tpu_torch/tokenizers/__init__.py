"""GPT-2 byte-level BPE and CLIP's BPE; `regex` is imported only when a
tokenizer is built."""

from .api import GPT2TokenizerWrapper, GPTJTokenizerWrapper, create_tokenizer

__all__ = ["GPT2TokenizerWrapper", "GPTJTokenizerWrapper", "create_tokenizer"]
