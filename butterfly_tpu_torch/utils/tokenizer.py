"""Tokenizers.

`ByteTokenizer` is the dependency-free default (UTF-8 bytes + specials) so
the framework runs end-to-end with zero downloaded assets. `load_tokenizer`
upgrades to a HF tokenizer when one is available locally (offline-safe:
never hits the network).
"""
from __future__ import annotations

from typing import List, Optional, Sequence


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255 are bytes, 256=BOS, 257=EOS."""

    vocab_size = 258
    bos_id = 256
    eos_id = 257

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """Thin adapter over a transformers tokenizer loaded from local files."""

    def __init__(self, tok):
        self.tok = tok
        self.vocab_size = tok.vocab_size
        self.bos_id = tok.bos_token_id
        self.eos_id = tok.eos_token_id

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self.tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(list(ids), skip_special_tokens=True)


def load_tokenizer(path_or_name: Optional[str] = None):
    """Local HF tokenizer if `path_or_name` resolves offline; else bytes."""
    if path_or_name:
        try:
            from transformers import AutoTokenizer
            tok = AutoTokenizer.from_pretrained(path_or_name,
                                                local_files_only=True)
            return HFTokenizer(tok)
        except Exception:
            pass
    return ByteTokenizer()
