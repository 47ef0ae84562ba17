"""D4M-backed data pipeline: triple ingest → associative arrays → batches
(the JAX package's ``repro.data.pipeline`` on the port's host ``Assoc``).

This is the paper's technology doing the framework's data work:

1. **Ingest**: documents arrive as ``(doc_id, position, token)`` triples —
   the canonical D4M representation — and are held as an ``Assoc`` whose
   constructor performs dedup/aggregation exactly as §II.A prescribes.
2. **Statistics**: corpus-level artifacts are semiring algebra on that
   array: term-document counts are ``A.logical().sum(0)``, co-occurrence is
   the classic ``AᵀA`` (``sqin``), doc-similarity ``AAᵀ`` (``sqout``).
3. **Sharding**: the *Distributed* D — the doc keyspace is row-partitioned
   across data-parallel hosts by rank range.  Each host draws only from
   its shard.
4. **Determinism & elasticity**: batch order is a pure function of
   ``(seed, step, shard)``; the cursor state is three integers,
   checkpointed with the model, so same-topology restarts replay
   token-exactly.  Re-sharding to a different host count deterministically
   yields a *different but valid* schedule over the same corpus — doc
   ranges re-partition cleanly.

Batches are numpy int32 arrays; the train launcher moves them to its device.
The windows are drawn from the shard's flat token stream: a stream of at
most ``seq_len + 2`` tokens starts every window at token 0, and one of at
most ``seq_len`` tokens gives labels shorter than the tokens (the launcher's
64-document corpus holds 1406 tokens), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import Assoc, KeySpace
from .tokenizer import ByteTokenizer


@dataclasses.dataclass
class PipelineState:
    """Checkpointable cursor: everything needed for exact-token resume."""
    step: int = 0
    seed: int = 0
    epoch: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict) -> "PipelineState":
        return PipelineState(**d)


def synth_corpus(n_docs: int = 64, seed: int = 0) -> List[str]:
    """Deterministic synthetic corpus (zipf-ish word soup)."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:03d}" for i in range(200)]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    return [" ".join(rng.choice(vocab, size=rng.integers(8, 40), p=p))
            for _ in range(n_docs)]


class CorpusPipeline:
    """Triple-store corpus → fixed-length token batches for one host shard."""

    def __init__(self, docs: List[str], *, tokenizer: Optional[ByteTokenizer] = None,
                 seq_len: int = 128, batch_per_shard: int = 4,
                 shard: int = 0, n_shards: int = 1, seed: int = 0):
        self.tokenizer = tokenizer or ByteTokenizer().fit(docs)
        self.seq_len = seq_len
        self.batch = batch_per_shard
        self.shard, self.n_shards = shard, n_shards
        self.state = PipelineState(seed=seed)

        # --- D4M ingest: (doc, pos, token) triples → Assoc ---------------
        rows, cols, vals = [], [], []
        self._token_streams: List[np.ndarray] = []
        for d_i, doc in enumerate(docs):
            ids = self.tokenizer.encode(doc)
            self._token_streams.append(ids)
            rows.extend([f"doc{d_i:06d}"] * len(ids))
            cols.extend(range(len(ids)))
            vals.extend(ids.astype(float) + 1.0)  # +1: token id 0 is valid
        self.table = Assoc(rows, cols, vals, aggregate="last")

        # row-keyspace sharding: this host's contiguous doc-rank range
        self.doc_space = KeySpace(np.asarray(
            [f"doc{d_i:06d}" for d_i in range(len(docs))]))
        per = (len(docs) + n_shards - 1) // n_shards
        self.doc_lo, self.doc_hi = shard * per, min((shard + 1) * per, len(docs))

        # flat token stream for this shard (documents joined)
        ids = [self._token_streams[i] for i in range(self.doc_lo, self.doc_hi)]
        self.flat = (np.concatenate(ids) if ids
                     else np.zeros((1,), np.int32))

    # --- corpus statistics (the paper's analytics idioms) -----------------
    def term_doc(self) -> Assoc:
        """token × doc incidence (Aᵀ as an associative array)."""
        return self.table.logical().transpose()

    def cooccurrence(self) -> Assoc:
        """position-free token co-occurrence via AᵀA (sqin)."""
        return self.table.logical().sqin()

    def doc_similarity(self) -> Assoc:
        return self.table.logical().sqout()

    # --- batching ----------------------------------------------------------
    def _offsets_for(self, step: int) -> np.ndarray:
        """Deterministic window starts for (seed, step) — order-independent
        of when/where it's called, so resume/elastic replay is exact."""
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + step) * (self.shard + 1))
        hi = max(len(self.flat) - self.seq_len - 1, 1)
        return rng.integers(0, hi, size=self.batch)

    def next_batch(self) -> Dict[str, np.ndarray]:
        offs = self._offsets_for(self.state.step)
        toks = np.stack([self.flat[o:o + self.seq_len] for o in offs])
        labels = np.stack([self.flat[o + 1:o + self.seq_len + 1] for o in offs])
        self.state.step += 1
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    # --- checkpoint/elastic ------------------------------------------------
    def state_dict(self) -> Dict:
        return self.state.to_dict()

    def load_state_dict(self, d: Dict):
        self.state = PipelineState.from_dict(d)
