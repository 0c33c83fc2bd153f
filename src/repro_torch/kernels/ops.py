"""Public entry points of the kernels, dispatched by device.

CPU tensors go to the plain PyTorch version of a kernel, CUDA tensors to
the hand-written CUDA kernel, and anything else raises. The choice
follows the tensors alone: there is no fallback from the kernel to the
plain version on the card (a kernel that does not build or launch
raises). This is the counterpart of ``repro.kernels.ops``, whose
``INTERPRET`` flag runs the Pallas kernels in interpret mode off the TPU.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import gqa_decode as _dense
from repro_torch.kernels import paged_decode as _paged
from repro_torch.kernels import textrank as _textrank

KERNELS = (_dense.KERNEL, _paged.KERNEL, _textrank.KERNEL)


def _route(t, what: str) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{what}: no implementation for device {t.device}")


def gqa_decode(q, k_cache, v_cache, valid, active=None):
    """Flash-decode attention over the dense cache; see
    kernels/gqa_decode.py. Rows with active=False return exact zeros."""
    if _route(q, "gqa_decode") == "cpu":
        return _dense.gqa_decode_plain(q, k_cache, v_cache, valid, active)
    return _dense.gqa_decode_cuda(q, k_cache, v_cache, valid, active)


def paged_gqa_decode(q, k_pages, v_pages, block_tables, seq_lens,
                     active=None):
    """Flash-decode attention over the paged block pool; see
    kernels/paged_decode.py. Rows with active=False return exact zeros."""
    if _route(q, "paged_gqa_decode") == "cpu":
        return _paged.paged_gqa_decode_plain(q, k_pages, v_pages,
                                             block_tables, seq_lens, active)
    return _paged.paged_gqa_decode_cuda(q, k_pages, v_pages, block_tables,
                                        seq_lens, active)


def textrank_scores(sim: np.ndarray, damping: float = 0.85, iters: int = 30,
                    device="cuda",
                    stream: Optional[torch.cuda.Stream] = None) -> np.ndarray:
    """Drop-in for ``core.compression.textrank_scores_np``: numpy (N, N)
    in, the (N,) f32 PageRank vector out; see kernels/textrank.py. The
    matrix is cast to f32 on the host and moved to ``device``: on the CPU
    the plain version scores it; on a card the kernel does, on ``stream``
    when given (the gateway's own, so a compression never queues behind
    an engine's work), and the copy back is the one sync."""
    sim = torch.from_numpy(np.ascontiguousarray(sim, dtype=np.float32))
    if sim.shape[0] == 0:
        return np.zeros(0, np.float32)
    dev = torch.device(device)
    on_stream = (torch.cuda.stream(stream) if stream is not None
                 else contextlib.nullcontext())
    with on_stream:
        sim = sim.to(dev)
        if _route(sim, "textrank_scores") == "cpu":
            return _textrank.textrank_plain(sim, damping, iters).numpy()
        return _textrank.textrank_cuda(sim, damping, iters).cpu().numpy()
