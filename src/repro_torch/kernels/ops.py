"""Public entry points of the decode kernels, dispatched by device.

CPU tensors go to the plain PyTorch version of a kernel, CUDA tensors to
the hand-written CUDA kernel, and anything else raises. The choice
follows the tensors alone: there is no fallback from the kernel to the
plain version on the card (a kernel that does not build or launch
raises). This is the counterpart of ``repro.kernels.ops``, whose
``INTERPRET`` flag runs the Pallas kernels in interpret mode off the TPU.
"""
from __future__ import annotations

from repro_torch.kernels import gqa_decode as _dense
from repro_torch.kernels import paged_decode as _paged

KERNELS = (_dense.KERNEL, _paged.KERNEL)


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
