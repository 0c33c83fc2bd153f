"""Flash-decode GQA attention over the paged KV block pool: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``_paged_decode_kernel`` /
``paged_gqa_decode`` of ``src/repro/kernels/paged_decode.py``. The
kernel (``csrc/paged_decode.cu``) is bound by memory traffic on an
H100: it reads each K/V element of a row's first ``seq_len`` tokens
once, through the row's block table (clamped to ``[0, P-1]``, loaded by
the kernel itself for every block it reads, so rows may alias blocks),
reads nothing past ``seq_len`` or of an inactive row, and splits the
logical token axis over many thread blocks (``num_splits``).

``paged_gqa_decode_plain`` is the function both compute:
``kernels/ref.py``'s ``paged_gqa_decode_ref`` plus exact zeros for
inactive rows. Callers go through ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.gqa_decode import (DTYPES, check_common, check_kv,
                                            gqa_decode_plain, num_splits)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

KERNEL = CudaKernel("paged_decode", "paged_decode_launch", [
    _P, _P, _P, _P, _P, _P,         # q, k, v, block_tables, seq_lens, active
    _P, _P, _P, _P,                 # out, part_m, part_l, part_acc
    _I, _I, _I, _I, _I, _I, _I,     # B, H, Hkv, HD, P, BLOCK_S, NB
    _L, _L,                         # page block and token strides
    _I, ctypes.c_float, _I, _P])    # nsplit, scale, dtype, stream


def paged_gqa_decode_plain(q, k_pages, v_pages, block_tables, seq_lens,
                           active=None):
    """q: (B, H, hd); k_pages/v_pages: (P, BLOCK_S, Hkv, hd);
    block_tables: (B, NB) int; seq_lens: (B,) valid tokens (pos + 1);
    active: optional (B,) bool. Gathers each row's blocks through its
    table (clamped to [0, P-1]) and runs the dense plain version.
    Returns (B, H*hd); inactive rows are exact zeros."""
    b, nb = block_tables.shape
    bs = k_pages.shape[1]
    bt = block_tables.long().clamp(0, k_pages.shape[0] - 1)
    k = k_pages[bt].reshape(b, nb * bs, *k_pages.shape[2:])
    v = v_pages[bt].reshape(b, nb * bs, *v_pages.shape[2:])
    valid = torch.arange(nb * bs, device=q.device)[None, :] \
        < seq_lens[:, None]
    return gqa_decode_plain(q, k, v, valid, active)


def paged_gqa_decode_cuda(q, k_pages, v_pages, block_tables, seq_lens,
                          active: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel; same contract as
    :func:`paged_gqa_decode_plain`. Raises on anything the kernel does
    not take."""
    check_common(q, active, "paged_gqa_decode")
    check_kv(q, k_pages, v_pages, "paged_gqa_decode")
    b, h, hd = q.shape
    p_blocks, bs, hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    for name, t, shape in (("block_tables", block_tables,
                            (b, block_tables.shape[-1])),
                           ("seq_lens", seq_lens, (b,))):
        if t.dtype != torch.int32 or t.shape != shape \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"paged_gqa_decode: {name} must be a contiguous "
                             f"int32 {shape} tensor on q's device")
    nb = block_tables.shape[1]
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=q.device)
    nsplit = num_splits(nb * bs)
    qpk = h // hkv
    out = torch.empty((b, h * hd), dtype=q.dtype, device=q.device)
    part_m = torch.empty((b, hkv, nsplit, qpk), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, hkv, nsplit, qpk, hd), dtype=torch.float32,
                           device=q.device)
    fn = KERNEL.function()
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), active.data_ptr(),
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), b, h, hkv, hd, p_blocks, bs, nb,
            k_pages.stride(0), k_pages.stride(1), nsplit,
            1.0 / math.sqrt(hd), DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    KERNEL.launches += 1
    KERNEL.check(rc)
    return out
