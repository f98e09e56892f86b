"""Byte-level tokenizer (no vocabulary files): the port's copy of
``repro.data.tokenizer``.

ids 0..255 are raw bytes; specials follow. Models with larger vocabularies
leave the tail unused, which is enough for training demos, and the AoT
vocabulary lookup is exercised identically.
"""
from __future__ import annotations

from typing import List

PAD, BOS, EOS = 256, 257, 258
N_SPECIAL = 3


class ByteTokenizer:
    vocab_size = 256 + N_SPECIAL
    pad_id, bos_id, eos_id = PAD, BOS, EOS

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [BOS] + ids
        if add_eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        bs = bytes(i for i in ids if 0 <= int(i) < 256)
        return bs.decode("utf-8", errors="replace")
