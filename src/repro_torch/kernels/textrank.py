"""TextRank, the C&R compressor's PageRank: the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas kernel ``_textrank_kernel`` / ``textrank_pallas`` of
``src/repro/kernels/textrank.py``. The kernel (``csrc/textrank.cu``)
runs the whole damped power iteration in one thread block, in one
launch; its design and bound are noted in the source.

Both versions take the unpadded (N, N) similarity matrix (the Pallas
kernel's padding to 128 was for the TPU's matrix unit) and compute in
f32: zero the diagonal, take column sums (a sum <= 0 counts as 1), and
from p = 1/N run ``iters`` steps of ``p = (1-d)/N + d * (W_n p)``.
``textrank_plain`` follows ``kernels/ref.py``'s ``textrank_ref`` and the
Pallas body (normalise W, then multiply: ``wn @ p``); the kernel follows
numpy's ``textrank_scores_np`` (``w @ (p / colsum)``). The orders agree
to f32 rounding. Callers go through ``kernels.ops.textrank_scores``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel

# p, p / colsum and the column sums live in the block's shared memory
# (12 N bytes of the H100's 227 KB opt-in per block)
MAX_N = 232448 // 12

KERNEL = CudaKernel("textrank", "textrank_launch", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,     # sim, N, row stride
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,     # damping, iters, out
    ctypes.c_void_p])                                  # stream


def textrank_plain(sim: torch.Tensor, damping: float = 0.85,
                   iters: int = 30) -> torch.Tensor:
    """sim: (N, N). Returns the (N,) f32 PageRank vector; N = 0 gives an
    empty vector."""
    n = sim.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=sim.device)
    w = sim.float().clone()
    w.fill_diagonal_(0.0)
    colsum = w.sum(dim=0)
    colsum = torch.where(colsum <= 0.0, torch.ones_like(colsum), colsum)
    wn = w / colsum[None, :]
    p = torch.full((n,), 1.0 / n, dtype=torch.float32, device=sim.device)
    for _ in range(iters):
        p = (1.0 - damping) / n + damping * (wn @ p)
    return p


def textrank_cuda(sim: torch.Tensor, damping: float = 0.85,
                  iters: int = 30) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; same contract as
    :func:`textrank_plain` for a contiguous-row f32 (N, N) CUDA tensor.
    Raises on anything the kernel does not take."""
    if sim.device.type != "cuda":
        raise ValueError("textrank: the kernel takes CUDA tensors only")
    n = sim.shape[0]
    if sim.dim() != 2 or sim.shape[1] != n or sim.dtype != torch.float32 \
            or (n > 1 and sim.stride(1) != 1):
        raise ValueError("textrank: sim must be a square float32 matrix "
                         "with contiguous rows")
    if n > MAX_N:
        raise ValueError(f"textrank: {n} sentences exceed the kernel's "
                         f"{MAX_N} (shared-memory vectors)")
    out = torch.empty(n, dtype=torch.float32, device=sim.device)
    if n == 0:
        return out
    fn = KERNEL.function()
    rc = fn(sim.data_ptr(), n, sim.stride(0), damping, iters, out.data_ptr(),
            torch.cuda.current_stream(sim.device).cuda_stream)
    KERNEL.launches += 1
    KERNEL.check(rc)
    return out
