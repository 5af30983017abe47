"""The port's PLEX-packed data pipeline against the reference's
(``repro.data.packing``): the same corpus, the same document locations
(each equal to ``np.searchsorted``), and byte-identical batches for every
step and host tried; the port's versions of
``tests/test_substrate.py``'s packing tests.
"""
import numpy as np
import pytest

from repro.data.packing import PackedPipeline as RPipeline
from repro.data.packing import SyntheticCorpus as RCorpus
from repro_torch.data.packing import (PackedIndex, PackedPipeline,
                                      SyntheticCorpus)


def test_packing_locate_exact(rng):
    corpus = SyntheticCorpus(n_docs=3000, vocab=100, seed=3)
    pipe = PackedPipeline(corpus, seq_len=64, global_batch=4)
    pos = rng.integers(0, corpus.total_tokens - 1, 4000).astype(np.uint64)
    d, o = pipe.index.locate(pos)
    dref = np.searchsorted(corpus.boundaries, pos, side="right") - 1
    assert np.array_equal(d, dref)
    assert np.array_equal(o, (pos - corpus.boundaries[d]).astype(np.int64))
    # every boundary itself starts its document
    d, o = pipe.index.locate(corpus.boundaries[:-1])
    assert np.array_equal(d, np.arange(corpus.n_docs)) and not o.any()


def test_packing_resumable():
    corpus = SyntheticCorpus(n_docs=500, vocab=50, seed=4)
    pipe = PackedPipeline(corpus, seq_len=32, global_batch=4, n_hosts=2)
    a = pipe.batch(7, host=1)
    pipe2 = PackedPipeline(corpus, seq_len=32, global_batch=4, n_hosts=2)
    b = pipe2.batch(7, host=1)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert np.array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_batches_identical_to_the_reference(n_hosts):
    """Every (step, host) of a run, through a wrap of the corpus: the
    reference's tokens and labels, dtype and all."""
    args = dict(n_docs=300, vocab=512, seed=11, mean_len=96)
    corpus, rcorpus = SyntheticCorpus(**args), RCorpus(**args)
    assert np.array_equal(corpus.boundaries, rcorpus.boundaries)
    pipe = PackedPipeline(corpus, seq_len=32, global_batch=8,
                          n_hosts=n_hosts)
    rpipe = RPipeline(rcorpus, seq_len=32, global_batch=8, n_hosts=n_hosts)
    steps = range(0, corpus.total_tokens // pipe.tokens_per_step + 3, 7)
    for step in steps:
        for host in range(n_hosts):
            got, want = pipe.batch(step, host), rpipe.batch(step, host)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype == np.int32
                assert np.array_equal(got[k], want[k]), (step, host, k)


def test_index_locates_like_the_reference():
    args = dict(n_docs=20_000, vocab=32_000, seed=0)
    corpus = SyntheticCorpus(**args)
    rpipe = RPipeline(RCorpus(**args), seq_len=8, global_batch=1)
    pos = np.random.default_rng(1).integers(
        0, corpus.total_tokens - 1, 50_000).astype(np.uint64)
    got = PackedIndex(corpus).locate(pos)
    want = rpipe.index.locate(pos)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
