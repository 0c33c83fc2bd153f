"""Compress-and-Route extractive compression pipeline (paper §5.2).

Pure classical NLP — no LLM inference:
  1. Unicode-aware sentence split.
  2. Composite sentence score: TextRank (w=0.20), Position (w=0.40),
     TF-IDF (w=0.35), Novelty (w=0.05).
  3. Greedy selection in score order, always retaining the first 3 and
     last 2 sentences (primacy/recency invariant).
  4. Stop at the token budget T_c = B_short - L_out, which guarantees
     T_c + L_out = B_short: a compressed request can never overflow the
     short pool's KV cache (paper Eq. 15, "hard OOM guarantee").

The TextRank similarity matrix + power iteration is the compute hot
spot; ``repro.kernels.ops.textrank_scores`` provides the Pallas-backed
path and this module falls back to numpy when JAX is unavailable or the
sentence count is tiny.
"""
from __future__ import annotations

import dataclasses
import math
import re
import time
import unicodedata
from typing import Callable, List, Optional, Sequence

import numpy as np

# composite weights (paper §5.2)
W_TEXTRANK = 0.20
W_POSITION = 0.40
W_TFIDF = 0.35
W_NOVELTY = 0.05

PRIMACY = 3   # always keep first 3 sentences
RECENCY = 2   # always keep last 2 sentences

_SENT_BOUNDARY = re.compile(
    r"""(?<=[.!?。！？؟])["'”’\)\]]*\s+|\n{2,}""", re.UNICODE)
_WORD = re.compile(r"[\w']+", re.UNICODE)


def count_tokens(text: str, bytes_per_token: float = 4.0) -> int:
    """Deterministic token estimate: ceil(utf-8 bytes / bytes-per-token).

    Matches the router's bytes-per-token EMA convention (paper §2.1) so
    the budget arithmetic (Eq. 15) is exact by construction.
    """
    return max(1, math.ceil(len(text.encode("utf-8")) / bytes_per_token))


def split_sentences(text: str) -> List[str]:
    """Unicode-aware heuristic sentence splitter (paper §5.2 step 1)."""
    text = unicodedata.normalize("NFC", text)
    parts = [p.strip() for p in _SENT_BOUNDARY.split(text)]
    sents = [p for p in parts if p]
    if not sents:
        return [text.strip()] if text.strip() else []
    # merge very short fragments (e.g. "Dr." artifacts) into the next one
    merged: List[str] = []
    carry = ""
    for s in sents:
        if len(s) < 8 and carry == "":
            carry = s
            continue
        merged.append((carry + " " + s).strip() if carry else s)
        carry = ""
    if carry:
        merged.append(carry)
    return merged


def _tokenize(sent: str) -> List[str]:
    return [w.lower() for w in _WORD.findall(sent)]


def tfidf_matrix(sentences: Sequence[str]) -> np.ndarray:
    """Rows = L2-normalized TF-IDF vectors (dense; vocab = corpus words)."""
    docs = [_tokenize(s) for s in sentences]
    vocab = {}
    for d in docs:
        for w in d:
            vocab.setdefault(w, len(vocab))
    n, v = len(docs), max(1, len(vocab))
    tf = np.zeros((n, v), dtype=np.float64)
    for i, d in enumerate(docs):
        for w in d:
            tf[i, vocab[w]] += 1.0
        if d:
            tf[i] /= len(d)
    df = (tf > 0).sum(axis=0)
    idf = np.log((1.0 + n) / (1.0 + df)) + 1.0
    m = tf * idf
    norms = np.linalg.norm(m, axis=1, keepdims=True)
    return m / np.maximum(norms, 1e-12)


def textrank_scores_np(sim: np.ndarray, damping: float = 0.85,
                       iters: int = 30) -> np.ndarray:
    """PageRank power iteration over the sentence-similarity graph.

    Reference (numpy) implementation; the Pallas kernel in
    repro/kernels/textrank.py computes the same fixpoint on TPU.
    """
    n = sim.shape[0]
    w = sim.copy()
    np.fill_diagonal(w, 0.0)
    colsum = w.sum(axis=0)
    colsum[colsum == 0] = 1.0
    p = np.full(n, 1.0 / n)
    for _ in range(iters):
        p = (1 - damping) / n + damping * (w @ (p / colsum))
    return p


@dataclasses.dataclass
class CompressionResult:
    text: str
    original_tokens: int
    compressed_tokens: int
    kept_indices: List[int]
    success: bool              # fit within budget
    latency_ms: float
    scores: Optional[np.ndarray] = None

    @property
    def token_reduction(self) -> float:
        if self.original_tokens == 0:
            return 0.0
        return 1.0 - self.compressed_tokens / self.original_tokens


class ExtractiveCompressor:
    """The C&R gateway compressor (paper §5.2)."""

    def __init__(self, bytes_per_token: float = 4.0,
                 textrank_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.bytes_per_token = bytes_per_token
        self._textrank = textrank_fn or textrank_scores_np

    def score_sentences(self, sentences: Sequence[str]) -> np.ndarray:
        n = len(sentences)
        if n == 0:
            return np.zeros(0)
        m = tfidf_matrix(sentences)
        sim = m @ m.T
        # TextRank centrality
        tr = self._textrank(sim)
        tr = tr / max(tr.max(), 1e-12)
        # Position: primacy-weighted exponential decay + recency bump
        idx = np.arange(n)
        pos = np.maximum(np.exp(-idx / max(4.0, n / 4.0)),
                         np.exp(-(n - 1 - idx) / 3.0))
        # TF-IDF salience: mean tf-idf weight of the sentence's terms
        sal = m.sum(axis=1) / np.maximum((m > 0).sum(axis=1), 1)
        sal = sal / max(sal.max(), 1e-12)
        # Novelty: 1 - max similarity to any *earlier* sentence
        max_prev = np.zeros(n)
        if n > 1:
            max_prev[1:] = np.maximum.accumulate(
                np.max(np.tril(sim, k=-1), axis=1)[1:])
        nov = 1.0 - np.clip(max_prev, 0.0, 1.0)
        return (W_TEXTRANK * tr + W_POSITION * pos
                + W_TFIDF * sal + W_NOVELTY * nov)

    def compress(self, text: str, token_budget: int) -> CompressionResult:
        """Greedy budgeted extractive compression (paper §5.2 steps 3-4)."""
        t0 = time.perf_counter()
        orig_tokens = count_tokens(text, self.bytes_per_token)
        if orig_tokens <= token_budget:
            return CompressionResult(text, orig_tokens, orig_tokens,
                                     [], True, _ms(t0))
        sentences = split_sentences(text)
        n = len(sentences)
        tok = np.array([count_tokens(s, self.bytes_per_token)
                        for s in sentences])
        scores = self.score_sentences(sentences)

        keep = set(range(min(PRIMACY, n))) | set(range(max(0, n - RECENCY), n))
        budget_used = int(tok[sorted(keep)].sum())
        # rank on quantized scores with a stable index tie-break: scorer
        # backends (numpy vs the Pallas textrank kernel) differ at
        # ~1e-8, which an unstable argsort amplifies into different
        # kept sets. Quantizing to 1e-6 makes cross-backend agreement
        # overwhelmingly likely (a score can still straddle a rounding
        # boundary, so this is a mitigation, not a proof).
        order = np.lexsort((np.arange(n), -np.round(scores, 6)))
        for i in order:
            i = int(i)
            if i in keep:
                continue
            if budget_used + tok[i] > token_budget:
                continue
            keep.add(i)
            budget_used += int(tok[i])
        kept = sorted(keep)
        out = " ".join(sentences[i] for i in kept)
        out_tokens = count_tokens(out, self.bytes_per_token)
        # Mandatory primacy/recency sentences may alone bust tiny budgets:
        # then compression FAILS (router sends the request to the long
        # pool) — the Eq. 15 guarantee is never violated by truncation.
        success = out_tokens <= token_budget
        return CompressionResult(out, orig_tokens, out_tokens, kept,
                                 success, _ms(t0), scores)


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1000.0


# --------------------------------------------------------------------------
# Fidelity metrics (paper App. C; BERTScore needs RoBERTa — offline we
# report ROUGE-L recall and TF-IDF cosine, see DESIGN.md §6).
# --------------------------------------------------------------------------
def rouge_l_recall(reference: str, candidate: str) -> float:
    a, b = _tokenize(reference), _tokenize(candidate)
    if not a:
        return 1.0
    # O(len(a)*len(b)) LCS with two rows
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1] / len(a)


def tfidf_cosine(reference: str, candidate: str) -> float:
    m = tfidf_matrix([reference, candidate])
    return float(np.clip(m[0] @ m[1], 0.0, 1.0))
