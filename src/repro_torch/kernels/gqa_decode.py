"""Flash-decode GQA attention over the dense KV cache: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas kernel ``_decode_kernel`` / ``gqa_decode`` of
``src/repro/kernels/gqa_decode.py``. The kernel (``csrc/gqa_decode.cu``)
is bound by memory traffic on an H100: it reads each K/V element of a
valid token once and skips masked tokens and inactive rows before loading
their K/V. The token axis is cut into 64-token work items, dealt round
robin to the ``CLUSTER`` blocks of one thread-block cluster per (row, kv
head), so a live row spreads over many SMs whatever its length, and the
cluster merges its blocks' states in the same launch. In bf16 the scores
and P.V run on the tensor cores, the softmax weights P as a bf16 hi/lo
pair, so P.V carries the f32 weights of the reference. Head dims 64, 128
and 192 and 1-16 query heads per kv head are served.

``gqa_decode_plain`` is the function both compute: ``kernels/ref.py``'s
``gqa_decode_ref`` plus exact zeros for inactive rows. Callers go
through ``kernels.ops``, which picks by the tensors' device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel

NEG_INF = -1e30
# csrc/decode_common.cuh's instantiations: head dims, and query heads per
# kv head (padded to one n8 MMA tile up to 8, two up to 16)
HEAD_DIMS = (64, 128, 192)
Q_PER_KV = tuple(range(1, 17))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

# csrc/decode_common.cuh's TILE, CL and MAX_ITEMS; the library refuses an
# item count that does not follow from its own
TILE = 64                          # tokens per work item
CLUSTER = 8                        # blocks per (row, kv head)
MAX_ITEMS = 256                    # work items per block

KERNEL = CudaKernel("gqa_decode", "gqa_decode_launch", [
    _P, _P, _P, _P, _P, _P,         # q, k, v, valid, active, out
    _I, _I, _I, _I, _I,             # B, S, H, Hkv, HD
    _L, _L,                         # K/V batch and token strides
    _I, ctypes.c_float, _I, _P])    # items, scale, dtype, stream


def gqa_decode_plain(q, k_cache, v_cache, valid, active=None):
    """q: (B, H, hd); k_cache/v_cache: (B, S, Hkv, hd); valid: (B, S)
    bool; active: optional (B,) bool. Returns (B, H*hd) in q's dtype;
    rows with active=False are exact zeros."""
    b, h, hd = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, hd).float()
    s = torch.einsum("bgqd,bsgd->bgqs", qg, k_cache.float()) / math.sqrt(hd)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqs,bsgd->bgqd", w, v_cache.float())
    out = o.reshape(b, h * hd).to(q.dtype)
    if active is not None:
        out = torch.where(active[:, None], out, torch.zeros_like(out))
    return out


def num_items(extent: int) -> int:
    """Work items of a row's token axis: one per ``TILE`` tokens of the
    extent (S, or NB * BLOCK_S). The launch's grid, (CLUSTER, Hkv, B),
    and this count depend on shapes alone, so a call never waits on a
    length read back from the card."""
    items = max(1, -(-extent // TILE))
    if -(-items // CLUSTER) > MAX_ITEMS:
        raise ValueError(f"decode kernels: {extent} tokens per row exceed "
                         f"{TILE * CLUSTER * MAX_ITEMS}")
    return items


def check_common(q, active, what: str) -> None:
    """Checks shared by both decode wrappers."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} unsupported "
                        f"(float32, bfloat16)")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"{what}: q must be a contiguous (B, H, hd) tensor")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {q.shape[2]} unsupported "
                         f"{HEAD_DIMS}")
    if active is not None and (active.dtype != torch.bool
                               or active.shape != (q.shape[0],)
                               or not active.is_contiguous()
                               or active.device != q.device):
        raise ValueError(f"{what}: active must be a contiguous (B,) bool "
                         f"tensor on {q.device}")


def check_kv(q, k, v, what: str) -> None:
    """K/V must share q's device and dtype, have the layout (..., Hkv, hd)
    with the last two dims contiguous, equal strides, and 16-byte aligned
    rows (the kernel's vector loads)."""
    hd = q.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} must match q's device and "
                             f"dtype")
        if t.dim() != 4 or t.shape[3] != hd or t.stride(3) != 1 \
                or t.stride(2) != hd:
            raise ValueError(f"{what}: {name} must be (*, *, Hkv, hd) with "
                             f"contiguous (Hkv, hd)")
        if t.data_ptr() % 16 or any(s % (16 // t.element_size())
                                    for s in t.stride()[:2]):
            raise ValueError(f"{what}: {name} rows must be 16-byte aligned")
    if k.shape != v.shape or k.stride() != v.stride():
        raise ValueError(f"{what}: k and v must share shape and strides")
    hkv = k.shape[2]
    if q.shape[1] % hkv or q.shape[1] // hkv not in Q_PER_KV:
        raise ValueError(f"{what}: H={q.shape[1]}, Hkv={hkv}: q_per_kv "
                         f"must be {Q_PER_KV[0]}-{Q_PER_KV[-1]}")


def gqa_decode_cuda(q, k_cache, v_cache, valid, active: Optional[torch.Tensor]
                    = None):
    """Launch the CUDA kernel; same contract as :func:`gqa_decode_plain`.
    Raises on anything the kernel does not take."""
    check_common(q, active, "gqa_decode")
    check_kv(q, k_cache, v_cache, "gqa_decode")
    b, h, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b:
        raise ValueError("gqa_decode: cache batch must equal q's")
    if valid.dtype != torch.bool or valid.shape != (b, s) \
            or not valid.is_contiguous() or valid.device != q.device:
        raise ValueError("gqa_decode: valid must be a contiguous (B, S) "
                         "bool tensor on q's device")
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=q.device)
    out = torch.empty((b, h * hd), dtype=q.dtype, device=q.device)
    fn = KERNEL.function()
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid.data_ptr(), active.data_ptr(), out.data_ptr(), b, s, h,
            hkv, hd, k_cache.stride(0), k_cache.stride(1), num_items(s),
            1.0 / math.sqrt(hd), DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    KERNEL.launches += 1
    KERNEL.check(rc)
    return out
