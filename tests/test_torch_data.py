"""Module step 9f on the CPU: the port's D4M data pipeline
(``repro_torch.data``) against the JAX package's (``repro.data``).

``tests/test_data.py``'s seven tests on the port, each holding the port to
the JAX package on the same documents: the tokenizer's vocabulary keys,
ids and decoding; batches equal for steps 0-3 at one and two shards and
after a resume; the shard doc ranges; the three corpus statistics
(``term_doc``, ``cooccurrence``, ``doc_similarity``) triple by triple;
the ingest table.  Then the launcher's corpus (``synth_corpus(64)``: 1406
tokens, 433 vocabulary entries) and where it runs short, in both
packages: from ``seq_len`` 1404 every window starts at token 0, and at
1406 the labels are one token shorter than the tokens (a caveat of the
reference, ROADMAP.md queue 3).  Everything here is host numpy: exact.
"""
import numpy as np
import pytest

from repro.data import ByteTokenizer as JByteTokenizer
from repro.data import CorpusPipeline as JCorpusPipeline
from repro.data import synth_corpus as j_synth_corpus
from repro_torch.data import ByteTokenizer, CorpusPipeline, synth_corpus

from _torch_helpers import _reset_port_stats  # noqa: F401
from _torch_helpers import assert_same_assoc


def _pair(docs, **kw):
    return CorpusPipeline(docs, **kw), JCorpusPipeline(docs, **kw)


def _assert_batches_equal(got, want):
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tokenizer_roundtrip_words():
    docs = ["the cat sat", "the dog sat", "the cat ran", "naïve dog"]
    tok = ByteTokenizer(vocab_size=300).fit(docs)
    jtok = JByteTokenizer(vocab_size=300).fit(docs)
    np.testing.assert_array_equal(tok.table.keys, jtok.table.keys)
    assert (tok.pad_id, tok.bos_id, tok.eos_id) == \
        (jtok.pad_id, jtok.bos_id, jtok.eos_id)
    for text in ("the cat sat", "a dog ran", "naïve zebra"):
        ids = tok.encode(text)
        np.testing.assert_array_equal(ids, jtok.encode(text))
        assert ids.dtype == np.int32
        assert tok.decode(ids) == jtok.decode(ids)
    ids = tok.encode("the cat sat")
    assert ids[0] == tok.bos_id and ids[-1] == tok.eos_id
    assert tok.decode(ids) == "the cat sat"


def test_synth_corpus_matches_jax():
    assert synth_corpus(16, seed=1) == j_synth_corpus(16, seed=1)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_pipeline_deterministic(n_shards):
    """Steps 0-3 of every shard equal JAX's, and a second pipeline on the
    same seed gives the same batches."""
    docs = synth_corpus(16, seed=1)
    for shard in range(n_shards):
        kw = dict(seq_len=32, batch_per_shard=2, shard=shard,
                  n_shards=n_shards, seed=7)
        p, jp = _pair(docs, **kw)
        p2 = CorpusPipeline(docs, **kw)
        for _ in range(4):
            b = p.next_batch()
            _assert_batches_equal(b, jp.next_batch())
            _assert_batches_equal(p2.next_batch(), b)
        assert p.state_dict() == jp.state_dict()


def test_pipeline_exact_resume():
    docs = synth_corpus(16, seed=2)
    p = CorpusPipeline(docs, seq_len=32, batch_per_shard=2, seed=5)
    for _ in range(3):
        p.next_batch()
    saved = p.state_dict()
    want = [p.next_batch() for _ in range(3)]

    p2, jp2 = _pair(docs, seq_len=32, batch_per_shard=2, seed=5)
    p2.load_state_dict(saved)
    jp2.load_state_dict(saved)
    for w in want:
        g = p2.next_batch()
        _assert_batches_equal(g, w)
        _assert_batches_equal(g, jp2.next_batch())


def test_labels_are_shifted_tokens():
    docs = synth_corpus(8, seed=3)
    p, jp = _pair(docs, seq_len=16, batch_per_shard=1, seed=0)
    b = p.next_batch()
    _assert_batches_equal(b, jp.next_batch())
    assert b["tokens"].shape == (1, 16) and b["labels"].shape == (1, 16)
    np.testing.assert_array_equal(b["tokens"][0, 1:], b["labels"][0, :-1])


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_sharding_disjoint_doc_ranges(n_shards):
    docs = synth_corpus(10, seed=4)
    ranges = []
    for s in range(n_shards):
        p, jp = _pair(docs, seq_len=8, batch_per_shard=1, shard=s,
                      n_shards=n_shards, seed=0)
        assert (p.doc_lo, p.doc_hi) == (jp.doc_lo, jp.doc_hi)
        np.testing.assert_array_equal(p.flat, jp.flat)
        ranges.append((p.doc_lo, p.doc_hi))
    covered = [d for lo, hi in ranges for d in range(lo, hi)]
    assert sorted(covered) == list(range(10))  # partition, no overlap


@pytest.mark.parametrize("stat", ["term_doc", "cooccurrence",
                                  "doc_similarity"])
def test_corpus_statistics_match_jax(stat):
    for docs in (["a b a", "b c"], synth_corpus(12, seed=6)):
        p, jp = _pair(docs, seq_len=4, batch_per_shard=1, seed=0)
        got, want = getattr(p, stat)(), getattr(jp, stat)()
        assert got.nnz() == want.nnz() > 0
        assert_same_assoc(got, want)
    co = _pair(["a b a", "b c"], seq_len=4, batch_per_shard=1)[0] \
        .cooccurrence().to_dict()
    for (i, j), val in co.items():
        assert co[(j, i)] == val     # AᵀA symmetric


def test_d4m_table_matches_tokens():
    docs = ["x y z", "x w"]
    p, jp = _pair(docs, seq_len=4, batch_per_shard=1, seed=0)
    assert_same_assoc(p.table, jp.table)
    ids = p.tokenizer.encode("x y z")
    r, c, v = p.table.triples()
    first = r == "doc000000"
    assert first.sum() == len(ids)
    # stored value = token id + 1 (zero-avoidance offset)
    got = [int(x) - 1 for x in v[first][np.argsort(c[first].astype(float))]]
    assert got == ids.tolist()


# -- the launcher's corpus -------------------------------------------------------

def test_launcher_corpus_size():
    """``launch.train``'s corpus: 1406 tokens in the flat stream (one per
    table entry), 433 vocabulary entries, in both packages."""
    docs = synth_corpus(n_docs=64, seed=0)
    p, jp = _pair(docs, seq_len=1024, batch_per_shard=4, seed=0)
    assert len(p.flat) == len(jp.flat) == 1406
    assert p.table.nnz() == jp.table.nnz() == 1406
    assert len(p.tokenizer.table) == len(jp.tokenizer.table) == 433
    for _ in range(2):
        _assert_batches_equal(p.next_batch(), jp.next_batch())


@pytest.mark.parametrize("seq_len,starts,label_len", [
    (1403, {0, 1}, 1403), (1404, {0}, 1404), (1405, {0}, 1405),
    (1406, {0}, 1405)])
def test_launcher_corpus_runs_short(seq_len, starts, label_len):
    """The reference's behaviour at the corpus' end, pinned in both
    packages: the window starts shrink to token 0 from ``seq_len`` 1404,
    and at 1406 the labels come out one token short of the tokens."""
    docs = synth_corpus(n_docs=64, seed=0)
    for pipe in _pair(docs, seq_len=seq_len, batch_per_shard=8, seed=0):
        assert set(pipe._offsets_for(0).tolist()) <= starts
        b = pipe.next_batch()
        assert b["tokens"].shape == (8, seq_len)
        assert b["labels"].shape == (8, label_len)
