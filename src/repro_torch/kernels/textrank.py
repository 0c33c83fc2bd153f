"""TextRank, the C&R compressor's PageRank: the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the Pallas kernel ``_textrank_kernel`` / ``textrank_pallas`` of
``src/repro/kernels/textrank.py``. The kernel (``csrc/textrank.cu``)
runs the whole damped power iteration in one cooperative launch of G
co-resident blocks, each holding its slice of rows in shared memory; its
design and bound are noted in the source. :func:`grid_plan` picks G, the
rows per block and the block size.

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
import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.build import CudaKernel

# One block's shared memory (232,448 B on an H100) holds q (p / colsum)
# twice and the column sums, 12 N bytes, when it runs alone; more blocks
# need less each (csrc/textrank.cu)
MAX_N = 232448 // 12
# The grid rule, from chip_smoke.py phase 3's sweep on an H100 (PERF.md,
# section 6): one block up to SINGLE_MAX sentences, where it beat every
# grid (a step costs one block barrier, not an exchange through L2);
# above, at least MIN_GRID blocks of at most ROWS rows, at most one
# block per SM (fewer, fuller blocks won: every block polls every
# block's words each step)
SINGLE_MAX = 96
MIN_GRID = 8
ROWS = 32
ROWS_AT_ONCE = 4                   # rows a warp takes per pass (textrank.cu)

KERNEL = CudaKernel("textrank", "textrank_launch", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,     # sim, N, row stride
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # rows, grid, threads
    ctypes.c_float, ctypes.c_int,                      # d, iters
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # colpart, q, out
    ctypes.c_void_p])                                  # stream


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's shape for ``n`` sentences: ``grid`` blocks of
    ``threads`` threads, block g owning rows [g * rows, min(n, (g + 1) *
    rows)). The library decides whether the rows are staged in shared
    memory (:func:`block`)."""
    n: int
    grid: int
    rows: int
    threads: int


@dataclasses.dataclass(frozen=True)
class Block:
    """A plan's block as the library launches it: blocks of its kind that
    fit one SM at once, its dynamic shared memory in bytes, and whether
    its rows are staged in shared memory."""
    per_sm: int
    smem: int
    staged: bool


def plan_for(n: int, grid: int) -> Plan:
    """The plan of about ``grid`` blocks for ``n`` sentences: rows split
    evenly, so no block is empty; one warp per ``ROWS_AT_ONCE`` rows
    (csrc/textrank.cu), up to 32 warps and at least 4 (8 in a grid, whose
    blocks gather q through L2: more loads in flight)."""
    rows = -(-n // max(1, min(grid, n)))
    grid = -(-n // rows)
    warps = min(32, max(8 if grid > 1 else 4, -(-rows // ROWS_AT_ONCE)))
    return Plan(n, grid, rows, 32 * warps)


def grid_plan(n: int, sms: int,
              blocks_per_sm: Callable[[Plan], int]) -> Plan:
    """The launch for ``n`` sentences on a card of ``sms`` SMs:
    one block up to ``SINGLE_MAX``, else at least ``MIN_GRID`` blocks of
    at most ``ROWS`` rows and at most ``sms`` blocks; halved until
    ``blocks_per_sm(plan)`` (the occupancy query) says every block is
    resident at once, which the kernel's waits on each other's words
    need."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"textrank: {n} sentences outside 1-{MAX_N}")
    grid = 1 if n <= SINGLE_MAX else min(sms, max(MIN_GRID, -(-n // ROWS)))
    while True:
        plan = plan_for(n, grid)
        if blocks_per_sm(plan) * sms >= plan.grid:
            return plan
        if plan.grid == 1:
            raise RuntimeError(f"textrank: no block of {plan} fits an SM")
        grid = plan.grid // 2


_BLOCKS: Dict[Tuple[int, Plan], Block] = {}


def block(plan: Plan, index: int) -> Block:
    """The library's block for ``plan`` on device ``index`` (its
    occupancy query), cached per plan."""
    key = (index, plan)
    if key not in _BLOCKS:
        query = KERNEL.extra("textrank_block", [ctypes.c_int] * 4
                             + [ctypes.POINTER(ctypes.c_int)] * 2)
        smem, staged = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            got = query(plan.n, plan.rows, plan.grid, plan.threads,
                        ctypes.byref(smem), ctypes.byref(staged))
        if got < 0:
            KERNEL.check(-got)
        _BLOCKS[key] = Block(got, smem.value, bool(staged.value))
    return _BLOCKS[key]


def device_plan(n: int, device: torch.device) -> Plan:
    """:func:`grid_plan` for ``device``, with the kernel's own occupancy
    query."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return grid_plan(n, sms, lambda plan: block(plan, index).per_sm)


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
    if n == 0:
        return torch.empty(0, dtype=torch.float32, device=sim.device)
    return _launch(sim, device_plan(n, sim.device), damping, iters)


def _launch(sim: torch.Tensor, plan: Plan, damping: float = 0.85,
            iters: int = 30) -> torch.Tensor:
    """One launch of ``plan`` on ``sim`` (checked by
    :func:`textrank_cuda`) on the current stream; chip_smoke.py's grid
    sweep and the card's tests call it with other plans."""
    out = torch.empty(plan.n, dtype=torch.float32, device=sim.device)
    # scratch of a grid > 1: the column partials [G][n] f32, and q [2][n]
    # as 64-bit words (value and step tag)
    colpart = qbuf = None
    if plan.grid > 1:
        colpart = torch.empty(plan.grid * plan.n, dtype=torch.float32,
                              device=sim.device)
        qbuf = torch.empty(2 * plan.n, dtype=torch.int64, device=sim.device)
    fn = KERNEL.function()
    with torch.cuda.device(sim.device):
        rc = fn(sim.data_ptr(), plan.n, sim.stride(0), plan.rows, plan.grid,
                plan.threads, damping, iters,
                colpart.data_ptr() if colpart is not None else None,
                qbuf.data_ptr() if qbuf is not None else None,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    KERNEL.launches += 1
    KERNEL.check(rc)
    return out
