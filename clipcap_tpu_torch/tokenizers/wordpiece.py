"""BERT WordPiece tokenizer (uncased) for the BLIP text models: a copy of
clipcap_tpu/tokenizers/wordpiece.py, pure Python.

BERT's basic tokenization (lowercase, accent stripping, punctuation
splitting, CJK spacing) and the published WordPiece algorithm over a local
vocab.txt; no network access. The surface the Gen-B code uses from BLIP's
HF tokenizer (reference sampling.py:294-298, :313-326): encode with
[CLS]/[SEP], the bos ([DEC]), sep and enc ([ENC]) ids, and decode with
special-token skipping plus '##'-piece merging.
"""

from __future__ import annotations

import unicodedata
from typing import List, Sequence


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    def __init__(self, vocab: dict, lowercase: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

        def tid(tok, default=None):
            return vocab.get(tok, default)

        self.cls_token_id = tid("[CLS]")
        self.sep_token_id = tid("[SEP]")
        self.pad_token_id = tid("[PAD]", 0)
        self.unk_token_id = tid(unk_token)
        # BLIP adds [DEC] (decoder bos) and [ENC] (itm/itc encoder) tokens
        self.dec_token_id = tid("[DEC]")
        self.enc_token_id = tid("[ENC]")
        self.bos_token_id = self.dec_token_id if self.dec_token_id is not None else self.cls_token_id
        specials = [self.cls_token_id, self.sep_token_id, self.pad_token_id,
                    self.unk_token_id, self.dec_token_id, self.enc_token_id]
        self.all_special_ids = sorted({s for s in specials if s is not None})

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    # ---- basic tokenization ---------------------------------------------------

    def _basic_tokenize(self, text: str) -> List[str]:
        text = unicodedata.normalize("NFC", text)
        out_chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
                continue
            if _is_cjk(cp):
                out_chars.append(f" {ch} ")
            elif ch.isspace():
                out_chars.append(" ")
            else:
                out_chars.append(ch)
        words = "".join(out_chars).split()

        tokens: List[str] = []
        for word in words:
            if self.lowercase:
                word = word.lower()
                word = "".join(
                    c for c in unicodedata.normalize("NFD", word)
                    if unicodedata.category(c) != "Mn"
                )
            current = []
            for ch in word:
                if _is_punctuation(ch):
                    if current:
                        tokens.append("".join(current))
                        current = []
                    tokens.append(ch)
                else:
                    current.append(ch)
            if current:
                tokens.append("".join(current))
        return tokens

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    # ---- public API ---------------------------------------------------------------

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in self._basic_tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab.get(t, self.unk_token_id) for t in self.tokenize(text)]
        if add_special_tokens:
            return [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.all_special_ids:
                continue
            toks.append(self.ids_to_tokens.get(i, self.unk_token))
        text = " ".join(toks).replace(" ##", "")
        # HF clean_up_tokenization: reattach punctuation and contractions
        for a, b in [(" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                     (" ' ", "' "), (" n't", "n't"), (" 'm", "'m"),
                     (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")]:
            text = text.replace(a, b)
        return text

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
