"""Byte-level tokenizer with a D4M vocabulary table (the JAX package's
``repro.data.tokenizer`` on the port's host ``Assoc`` and ``KeySpace``).

The vocabulary *is* an associative array ``V : token × "id" → rank`` — the
KeySpace mechanics the device arrays use (sorted-unique + rank) double as
the token dictionary, which is exactly the D4M worldview: a tokenizer is a
1-column table.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

from repro_torch.core import Assoc, KeySpace


class ByteTokenizer:
    """UTF-8 byte tokenizer + merged word vocabulary built via Assoc.

    Real deployments would plug a trained BPE here; the framework needs a
    deterministic, dependency-free tokenizer whose vocab is D4M-native.
    """

    def __init__(self, vocab_size: int = 512, specials: tuple = ("<pad>", "<bos>", "<eos>")):
        self.vocab_size = vocab_size
        self.specials = specials

    def fit(self, docs: Iterable[str]) -> "ByteTokenizer":
        # count words with constructor aggregation (collisions ⊕= sum)
        words: List[str] = []
        for d in docs:
            words.extend(d.split())
        if words:
            counts = Assoc(words, ["count"] * len(words), [1.0] * len(words),
                           aggregate="sum")
            r, _, v = counts.triples()
            order = np.argsort(-v)
            top = r[order][: self.vocab_size - 256 - len(self.specials)]
        else:
            top = np.asarray([], dtype=str)
        toks = list(self.specials) + [f"<0x{i:02x}>" for i in range(256)] + \
            top.astype(str).tolist()
        self.table = KeySpace(np.asarray(toks))
        self.pad_id = int(self.table.rank(np.asarray(["<pad>"]))[0][0])
        self.bos_id = int(self.table.rank(np.asarray(["<bos>"]))[0][0])
        self.eos_id = int(self.table.rank(np.asarray(["<eos>"]))[0][0])
        return self

    def encode(self, text: str) -> np.ndarray:
        out = [self.bos_id]
        for w in text.split():
            ranks, found = self.table.rank(np.asarray([w]), strict=False)
            if len(ranks) and found.all():
                out.append(int(ranks[0]))
            else:
                for b in w.encode("utf-8"):
                    r, _ = self.table.rank(np.asarray([f"<0x{b:02x}>"]))
                    out.append(int(r[0]))
        out.append(self.eos_id)
        return np.asarray(out, dtype=np.int32)

    def decode(self, ids: np.ndarray) -> str:
        toks = [str(self.table[int(i)]) for i in ids]
        return " ".join(t for t in toks if not t.startswith("<"))
