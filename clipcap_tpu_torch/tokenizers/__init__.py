"""GPT-2 byte-level BPE, CLIP's BPE and T5's `tokenizer.json`; `regex` and
`tokenizers` are imported only when a tokenizer is built."""

from .api import (GPT2TokenizerWrapper, GPTJTokenizerWrapper, T5TokenizerWrapper,
                  create_tokenizer)

__all__ = ["GPT2TokenizerWrapper", "GPTJTokenizerWrapper", "T5TokenizerWrapper",
           "create_tokenizer"]
