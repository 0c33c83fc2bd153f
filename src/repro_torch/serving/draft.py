"""Self-speculative draft proposer (DESIGN.md §Speculative decoding).

Prompt-lookup / n-gram drafting: the draft model IS the request's own
token history. Agent-style traffic (tool loops, templated JSON, quoted
context) repeats itself, so the longest suffix n-gram of
prompt + generated-so-far usually has an earlier occurrence whose
continuation predicts the next tokens. The proposer copies that
continuation; the engine's verify scan accepts the longest prefix that
matches the model's own greedy argmax — so speculation is exactly
output-preserving by construction, whatever the proposer guesses.

Host-side, pure numpy, O(len(history) * ngram_max) per call: it runs
between jitted dispatches on the scheduler thread and must never touch
the device.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

DEFAULT_NGRAM = 3


def propose_draft(history: Sequence[int], max_len: int,
                  ngram_max: int = DEFAULT_NGRAM) -> List[int]:
    """Propose up to ``max_len`` draft tokens continuing ``history``.

    Finds the MOST RECENT earlier occurrence of the longest matching
    suffix n-gram (n = ngram_max down to 1) and returns the tokens that
    followed it, truncated to ``max_len``. Returns [] when the history
    never repeats (the engine then degenerates to plain decode — a
    wrong or empty draft can only cost throughput, never correctness).

    Invariants (tests/test_properties.py pins them):
      * the returned list is a contiguous substring of ``history``;
      * len(result) <= max_len;
      * result is [] whenever max_len <= 0 or len(history) < 2.
    """
    if max_len <= 0 or len(history) < 2:
        return []
    h = np.asarray(history, dtype=np.int64)
    n_hi = min(int(ngram_max), len(h) - 1)
    for n in range(n_hi, 0, -1):
        suffix = h[-n:]
        # candidate start positions strictly before the suffix's own
        # start, so the continuation we copy actually exists
        windows = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        hits = np.flatnonzero((windows == suffix).all(axis=1))
        if hits.size == 0:
            continue
        start = int(hits[-1]) + n          # most recent occurrence
        cont = h[start:start + max_len]
        if cont.size:
            return [int(t) for t in cont]
    return []
