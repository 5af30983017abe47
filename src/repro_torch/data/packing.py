"""PLEX-indexed sequence packing (the port of ``repro.data.packing``).

Packing a token stream into fixed-length training sequences needs
``global token position -> (document id, offset)`` — a predecessor query
over the cumulative-token-count array. At corpus scale (10^8+ documents)
that array is exactly the sorted-u64-key workload PLEX indexes: we build a
PLEX over the document boundaries once (O(N), single pass) and answer every
pack step's batched queries through it. Correctness is the paper's eps
guarantee + bounded final search — verified against np.searchsorted in tests.

The pipeline is *stateless-resumable*: batch(step, host) is a pure function
of (seed, step, host), so restart/elastic-rescale just replays from the
checkpointed step (no iterator state to snapshot), and every host can verify
any other host's shard (straggler auditing).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import PLEX, build_plex


@dataclasses.dataclass
class SyntheticCorpus:
    """Deterministic synthetic tokenized corpus: doc lengths + token stream."""
    n_docs: int
    vocab: int
    seed: int = 0
    mean_len: int = 512

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        lens = rng.geometric(1.0 / self.mean_len, self.n_docs
                             ).astype(np.uint64) + np.uint64(16)
        self.doc_lens = lens
        self.boundaries = np.concatenate(
            [[np.uint64(0)], np.cumsum(lens)]).astype(np.uint64)
        self.total_tokens = int(self.boundaries[-1])

    def tokens(self, doc: int, start: int, n: int) -> np.ndarray:
        """Tokens [start, start+n) of a document (hash-based, O(n))."""
        rng = np.random.default_rng((self.seed << 20) ^ doc)
        # deterministic per-doc stream; skip-ahead via generator state is
        # avoided by hashing (doc, block) chunks
        out = np.empty(n, dtype=np.int32)
        blk = 4096
        i = 0
        while i < n:
            b = (start + i) // blk
            off = (start + i) % blk
            brng = np.random.default_rng((self.seed << 40) ^ (doc << 16) ^ b)
            # zipf-ish skew: a learnable unigram distribution (uniform would
            # pin CE at ln(V) and hide training-progress bugs)
            u = brng.random(blk)
            chunk = np.minimum((u ** 3 * self.vocab).astype(np.int32),
                               self.vocab - 1)
            take = min(blk - off, n - i)
            out[i:i + take] = chunk[off:off + take]
            i += take
        return out


class PackedIndex:
    """PLEX over document boundaries; batched position->document lookups."""

    def __init__(self, corpus: SyntheticCorpus, eps: int = 64):
        self.corpus = corpus
        self.plex: PLEX = build_plex(corpus.boundaries, eps=eps)

    def locate(self, positions: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Global token positions -> (doc ids, in-doc offsets). Exact."""
        positions = np.asarray(positions, dtype=np.uint64)
        # lower_bound over boundaries; boundary keys are unique so the
        # predecessor document is lb-1 except at exact boundary hits
        lb = self.plex.lookup(positions)
        exact = (self.corpus.boundaries[np.minimum(
            lb, self.corpus.n_docs)] == positions)
        doc = np.where(exact, lb, lb - 1).astype(np.int64)
        doc = np.clip(doc, 0, self.corpus.n_docs - 1)
        off = positions - self.corpus.boundaries[doc]
        return doc, off.astype(np.int64)


@dataclasses.dataclass
class PackedPipeline:
    """Deterministic packed-batch source feeding train_step."""
    corpus: SyntheticCorpus
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    eps: int = 64

    def __post_init__(self):
        self.index = PackedIndex(self.corpus, self.eps)
        self.tokens_per_step = self.seq_len * self.global_batch

    def batch(self, step: int, host: int = 0) -> dict:
        """Batch for (step, host): tokens + next-token labels [B/host, S]."""
        assert self.global_batch % self.n_hosts == 0
        b = self.global_batch // self.n_hosts
        start = (np.uint64(step) * np.uint64(self.tokens_per_step)
                 + np.uint64(host * b * self.seq_len))
        start = start % np.uint64(max(self.corpus.total_tokens
                                      - self.tokens_per_step - 1, 1))
        pos = start + np.arange(b, dtype=np.uint64) * np.uint64(self.seq_len)
        docs, offs = self.index.locate(pos)
        toks = np.empty((b, self.seq_len + 1), np.int32)
        for i, (d, o) in enumerate(zip(docs, offs)):
            # fill crossing document boundaries as a contiguous stream
            need = self.seq_len + 1
            row = []
            dd, oo = int(d), int(o)
            while need > 0:
                avail = int(self.corpus.doc_lens[dd]) - oo
                take = min(avail, need)
                row.append(self.corpus.tokens(dd, oo, take))
                need -= take
                dd = (dd + 1) % self.corpus.n_docs
                oo = 0
            toks[i] = np.concatenate(row)[:self.seq_len + 1]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
