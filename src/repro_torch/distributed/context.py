"""Parallel context: which mesh axes play which role, and the collectives.

The port of ``repro/distributed/context.py``. The port runs a mesh as an
SPMD program: one process per rank, joined by a ``torch.distributed``
process group, every rank running the same host logic on the same
requests and computing on its own shard of the weights and of the KV
cache. Data axes ("pod", "data") split a batch; the "model" axis splits
weights Megatron-style (tensor parallel), and the row-parallel products
end in an explicit :meth:`ParallelContext.all_reduce_sum` where the
reference's GSPMD inserts its all-reduce. Passing ``parallel=None`` to
the model runs everything local, as a context whose model axis has one
rank does.

This module is the only one of the port that calls ``torch.distributed``:
the collectives are methods of :class:`ParallelContext`, and
:func:`launch_ranks` spawns the ranks and joins them. The backend follows
where the ranks live (:func:`choose_backend`), and a run prints its
choice: NCCL when each rank owns a card of its own, gloo when ranks share
one card, gloo on the CPU.

Every multi-rank context belongs to ranks that :func:`launch_ranks`
spawned on one host. Under gloo they exchange their tensors and host
objects through memory they share, not through gloo's sockets: four ranks
on one H100 took 7.06 ms for a decode step's (4, 1, 4096) bf16 all-reduce
staged through the host over gloo, 0.95-0.97 ms this way, and 533-535
against 5.8-7.0 ms for a batch prefill's (8, 2048, 4096)
(``tests/tp_collective_probe.py``). Each exchange is a generation of :class:`_Exchange`: a rank writes
its part, publishes the generation in a shared flag word and reads its
peers' parts once every flag shows it. CPU tensors and host objects go
through shared files; CUDA tensors of ranks that share one card through
card buffers mapped into every rank (CUDA IPC), the order kept on the card
by interprocess events (no host synchronisation). Every rank sums its
peers' parts in rank order, so all hold the same bits. The process group
sets these up; under NCCL (a card a rank) it runs the tensor collectives
itself, on each rank's own card.

A mesh may be a submesh of the process group (a fleet's pool on ranks of
its own). Every rank makes the context of every submesh, at the same
point, since a process group is made by all ranks together; a rank
outside the mesh holds a context that says so (``member``) and runs none
of the mesh's collectives. Three exchanges span every rank of the
group (``world_context``), for what the ranks outside a mesh must see:
``broadcast_object`` (rank 0's routing decisions), ``share`` (a mesh's
readbacks, from its lead) and ``gather_whole`` (a tensor made whole from
the slices some ranks hold, on others: a pool's weights and host KV
moving to another submesh).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import datetime
import math
import os
import pickle
import shutil
import tempfile
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh

# the later slices of the port's sharded path, named by every refusal
SLICE_FAMILIES = ("the sharded-families slice (the non-dense families and "
                  "the sequence / block fallback under a mesh)")
SLICE_HTTP = "the sharded-HTTP slice (--http at tp > 1)"
SLICE_TRAIN = "the sharded-training slice (parallel=, --mesh, --zero1)"

# collectives of a half-precision tensor sum in f32 and round once
_WIDE = {torch.bfloat16: torch.float32, torch.float16: torch.float32}
# this process's rank, as launch_ranks started it: its directory of
# shared files and its timeout (empty outside launch_ranks)
_RANK: Dict[str, Any] = {}
OBJECT_SLOT = 1 << 22          # bytes of one rank's pickled host object
CHUNK_BYTES = 1 << 26          # bytes of one piece of ``gather_whole``


def later(what: str, slice_name: str) -> NotImplementedError:
    """The refusal of a case a later slice serves."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {slice_name} of the "
        "PyTorch port")


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def choose_backend(device: str, world: int) -> Tuple[str, str]:
    """(backend, why): NCCL when every rank owns a card of its own, gloo
    when ranks share one card or run on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo", "ranks on the CPU, exchanging through shared memory"
    cards = torch.cuda.device_count()
    if cards >= world:
        return "nccl", f"{world} rank(s) on {cards} card(s), one each"
    return "gloo", (f"{world} ranks share {cards} card(s), exchanging "
                    "through buffers on the card")


# -- shared-memory exchanges ---------------------------------------------------
class _Exchange:
    """One all-gather a generation among ``ranks``, synchronised by two
    shared flag words a rank: row 0 holds the generation a rank has
    published its part of, row 1 the generation it has finished reading.
    A rank writes its part of generation k only once every peer has
    finished k - 1, so one buffer a rank suffices."""

    def __init__(self, ranks: Sequence[int], group, tag: str):
        self.ranks = list(ranks)
        self.i = self.ranks.index(global_rank())
        self.group = group
        self.gen = 0
        self.tag = f"{tag}-" + "-".join(str(r) for r in self.ranks)
        path = self._path("flags")
        if self.i == 0:
            np.memmap(path, np.int64, "w+", shape=(2, len(ranks))).flush()
        dist.barrier(group=group)
        self.flags = np.memmap(path, np.int64, "r+", shape=(2, len(ranks)))

    def _path(self, what: str) -> str:
        return os.path.join(_RANK["dir"], f"{self.tag}-{what}")

    def _wait(self, row: int, gen: int) -> None:
        if (self.flags[row] >= gen).all():
            return
        t0, spins = time.monotonic(), 0
        while not (self.flags[row] >= gen).all():
            if time.monotonic() - t0 > _RANK["timeout"]:
                raise RuntimeError(
                    f"{self.tag}: a peer did not reach exchange {gen} "
                    f"within {_RANK['timeout']} s (flags {self.flags[row]})")
            # spin a while (a peer is usually microseconds behind), then
            # sleep, so waiting ranks leave the cores to the working one
            spins += 1
            if spins < 2000:
                os.sched_yield()
            else:
                time.sleep(5e-5)

    def begin(self) -> int:
        """Start the next generation: every peer has read the last."""
        self.gen += 1
        self._wait(1, self.gen - 1)
        return self.gen

    def publish(self) -> None:
        """This rank's part is written; wait for every peer's."""
        self.flags[0, self.i] = self.gen
        self._wait(0, self.gen)

    def finish(self) -> None:
        """This rank has read (or queued its reads of) every part."""
        self.flags[1, self.i] = self.gen


class _ObjectBoard(_Exchange):
    """All-gather of picklable host objects through a shared file."""

    def __init__(self, ranks, group):
        super().__init__(ranks, group, "objects")
        path = self._path("slots")
        if self.i == 0:
            np.memmap(path, np.uint8, "w+",
                      shape=(len(ranks), OBJECT_SLOT)).flush()
        dist.barrier(group=group)
        self.slots = np.memmap(path, np.uint8, "r+",
                               shape=(len(ranks), OBJECT_SLOT))

    def all_gather(self, obj) -> List[Any]:
        data = pickle.dumps(obj)
        if len(data) + 8 > OBJECT_SLOT:
            raise ValueError(f"a host object of {len(data)} B exceeds the "
                             f"{OBJECT_SLOT} B slot")
        self.begin()
        slot = self.slots[self.i]
        slot[:8] = np.frombuffer(np.int64(len(data)).tobytes(), np.uint8)
        slot[8:8 + len(data)] = np.frombuffer(data, np.uint8)
        self.publish()
        out = []
        for p in range(len(self.ranks)):
            n = int(np.frombuffer(self.slots[p, :8].tobytes(), np.int64)[0])
            out.append(pickle.loads(self.slots[p, 8:8 + n].tobytes()))
        self.finish()
        return out


class _CUipcMemHandle(ctypes.Structure):
    _fields_ = [("reserved", ctypes.c_ubyte * 64)]   # bytes, NULs kept


class _CardMemory:
    """Card buffers shared between the processes of one host: CUDA IPC
    through the driver API (``libcuda``), not torch's reference-counted
    sharing, which needs a file under /dev/shm that some hosts refuse to
    unlink (the H100 host of ``tests/tp_collective_probe.py`` did)."""
    _cu = None

    @classmethod
    def _lib(cls):
        if cls._cu is None:
            cu = ctypes.CDLL("libcuda.so.1")
            ptr = ctypes.POINTER(ctypes.c_uint64)
            for name, args in (
                    ("cuMemAlloc_v2", [ptr, ctypes.c_size_t]),
                    ("cuMemFree_v2", [ctypes.c_uint64]),
                    ("cuIpcGetMemHandle", [ctypes.POINTER(_CUipcMemHandle),
                                           ctypes.c_uint64]),
                    ("cuIpcOpenMemHandle_v2", [ptr, _CUipcMemHandle,
                                               ctypes.c_uint]),
                    ("cuIpcCloseMemHandle", [ctypes.c_uint64])):
                getattr(cu, name).argtypes = args
                getattr(cu, name).restype = ctypes.c_int
            cls._cu = cu
        return cls._cu

    @classmethod
    def _call(cls, name, *args) -> None:
        err = getattr(cls._lib(), name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed: CUresult {err}")

    @classmethod
    def alloc(cls, nbytes: int) -> Tuple[int, bytes]:
        """(device pointer, its IPC handle) of ``nbytes`` new bytes on the
        current card."""
        torch.cuda.current_blas_handle()        # the primary context is current
        p = ctypes.c_uint64()
        cls._call("cuMemAlloc_v2", ctypes.byref(p), nbytes)
        h = _CUipcMemHandle()
        cls._call("cuIpcGetMemHandle", ctypes.byref(h), p.value)
        return p.value, bytes(h.reserved)

    @classmethod
    def open(cls, handle: bytes) -> int:
        h = _CUipcMemHandle()
        h.reserved = (ctypes.c_ubyte * 64)(*handle)
        p = ctypes.c_uint64()
        cls._call("cuIpcOpenMemHandle_v2", ctypes.byref(p), h, 1)
        return p.value

    @classmethod
    def release(cls, ptr: int, mine: bool) -> None:
        cls._call("cuMemFree_v2" if mine else "cuIpcCloseMemHandle", ptr)

    @staticmethod
    def tensor(ptr: int, nbytes: int, device) -> torch.Tensor:
        """A uint8 tensor over ``nbytes`` at ``ptr`` (not owning it)."""
        class _View:
            __cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                        "data": (ptr, False), "version": 3,
                                        "strides": None}
        return torch.as_tensor(_View(), device=device)


class _TensorRing(_Exchange):
    """All-gather of tensors among the ranks of a model-axis row: each
    rank's part in a buffer every rank maps (a shared file for CPU
    tensors; a card buffer mapped by CUDA IPC, ordered by interprocess
    events, for CUDA tensors of ranks on one card). ``parts(x)`` returns
    the ranks' parts as views valid until ``finish()``."""

    def __init__(self, ranks, group, device: torch.device):
        super().__init__(ranks, group, f"ring-{device.type}")
        self.device = device
        self.cap = 0
        self.bufs: List[torch.Tensor] = []
        self.ptrs: List[int] = []
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev_write = torch.cuda.Event(interprocess=True)
            self.ev_done = torch.cuda.Event(interprocess=True)
            handles = [None] * len(ranks)
            dist.all_gather_object(
                handles, (self.ev_write.ipc_handle(),
                          self.ev_done.ipc_handle()), group=group)
            self.peer_write, self.peer_done = (
                [None if p == self.i else torch.cuda.Event.from_ipc_handle(
                    device, h[k]) for p, h in enumerate(handles)]
                for k in (0, 1))

    def _grow(self, nbytes: int) -> None:
        """Every rank's buffer of at least ``nbytes`` (all ranks ask at
        the same generation: their parts have one shape)."""
        if self.cuda:
            torch.cuda.synchronize()      # no read of the old buffers left
        dist.barrier(group=self.group)
        self.cap = max(nbytes, 2 * self.cap, 1 << 20)
        self.bufs = []
        if self.cuda:
            for p, ptr in enumerate(self.ptrs):
                _CardMemory.release(ptr, p == self.i)
            mine, handle = _CardMemory.alloc(self.cap)
            handles = [None] * len(self.ranks)
            dist.all_gather_object(handles, handle, group=self.group)
            self.ptrs = [mine if p == self.i else _CardMemory.open(h)
                         for p, h in enumerate(handles)]
            self.bufs = [_CardMemory.tensor(ptr, self.cap, self.device)
                         for ptr in self.ptrs]
        else:
            path = self._path(f"buf{self.cap}-{{}}")
            np.memmap(path.format(self.i), np.uint8, "w+",
                      shape=(self.cap,)).flush()
            dist.barrier(group=self.group)
            for p in range(len(self.ranks)):
                self.bufs.append(torch.from_numpy(np.memmap(
                    path.format(p), np.uint8, "r+", shape=(self.cap,))))

    def parts(self, x: torch.Tensor, write: bool = True
              ) -> List[torch.Tensor]:
        """``write`` False posts nothing: ``x`` (a meta tensor will do)
        gives only the shape and dtype of every part."""
        x = x.contiguous()
        nbytes = x.numel() * x.element_size()
        self.begin()
        if nbytes > self.cap:
            self._grow(nbytes)
        if self.cuda:
            stream = torch.cuda.current_stream(self.device)
            for ev in self.peer_done:          # peers done with my buffer
                if ev is not None:
                    stream.wait_event(ev)
        if write:
            self.bufs[self.i][:nbytes].copy_(x.view(-1).view(torch.uint8))
        if self.cuda:
            self.ev_write.record(stream)
        self.publish()
        if self.cuda:
            for ev in self.peer_write:
                if ev is not None:
                    stream.wait_event(ev)
        return [b[:nbytes].view(x.dtype).view(x.shape) for b in self.bufs]

    def finish(self) -> None:
        if self.cuda:
            self.ev_done.record(torch.cuda.current_stream(self.device))
        super().finish()


_EXCHANGES: Dict[Any, _Exchange] = {}


def _exchange(kind, ranks, group, device=None):
    """The process's exchange of ``kind`` among ``ranks`` (made on first
    use, which every rank of them reaches at the same point)."""
    key = (kind, tuple(ranks), None if device is None else device.type)
    if key not in _EXCHANGES:
        _EXCHANGES[key] = (_ObjectBoard(ranks, group) if kind == "objects"
                           else _TensorRing(ranks, group, device))
    return _EXCHANGES[key]


@dataclasses.dataclass(frozen=True, eq=False)
class ParallelContext:
    """One rank's view of a mesh: the axes' roles (as the reference's),
    the rank, the process group of its model-axis row (None where the row
    is the whole group or this rank alone) and that of the mesh (None
    where the mesh is the whole group). A rank outside the mesh holds a
    context too (``member`` False): it knows the mesh's ranks and its
    lead, and runs none of its collectives."""
    mesh: Mesh
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    rank: int = 0
    group: Any = None          # this rank's model-axis row
    backend: str = ""
    mesh_group: Any = None     # the mesh's ranks

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.data_axes) + (self.model_axis,)

    @property
    def ep_size(self) -> int:
        return self.mesh.shape[self.model_axis]

    @property
    def tp(self) -> int:
        """Ranks along the model axis (the tensor-parallel degree)."""
        return self.mesh.shape[self.model_axis]

    @property
    def member(self) -> bool:
        """Whether this rank is one of the mesh's."""
        return self.rank in self.mesh.ranks

    @property
    def lead(self) -> int:
        """The mesh's first rank: it publishes the mesh's readbacks."""
        return self.mesh.ranks[0]

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (a name or a tuple of names,
        row-major), as a spec entry reads them."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        at = self.mesh.coords(self.rank)
        i = 0
        for a in axes:
            i = i * self.mesh.shape[a] + at[a]
        return i

    @property
    def model_rank(self) -> int:
        return self.axis_index(self.model_axis)

    @property
    def data_rank(self) -> int:
        return self.axis_index(self.data_axes)

    # -- collectives ------------------------------------------------------
    def _row(self) -> List[int]:
        """This rank's model-axis row of global ranks, in model order."""
        at = self.mesh.coords(self.rank)
        index = tuple(at[a] if a != self.model_axis else slice(None)
                      for a in self.mesh.axis_names)
        return [int(r) for r in self.mesh.devices[index]]

    def _ring(self, t: torch.Tensor) -> Optional[_TensorRing]:
        """The shared-memory ring for ``t`` under gloo (the host's CPU
        tensors; CUDA tensors of ranks sharing a card); None under NCCL,
        which takes each rank's tensor on its own card."""
        if self.backend == "nccl":
            return None
        return _exchange("tensors", self._row(), self.group, t.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the model axis, the same bits on every
        rank (bf16 and f16 summed in f32 and rounded once; through the
        ring, in rank order)."""
        if self.tp == 1:
            return t
        wide = _WIDE.get(t.dtype, t.dtype)
        ring = self._ring(t)
        if ring is None:
            x = t.to(wide, copy=True)
            dist.all_reduce(x, group=self.group)
            return x.to(t.dtype)
        parts = ring.parts(t.to(wide))
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        ring.finish()
        return out.to(t.dtype)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model axis' shards of ``t`` concatenated along ``dim`` in
        rank order (moved as raw bytes: exact for every dtype; gloo has no
        16-bit integer type)."""
        if self.tp == 1:
            return t
        ring = self._ring(t)
        if ring is None:
            raw = t.contiguous().view(torch.uint8)
            parts = [torch.empty_like(raw) for _ in range(self.tp)]
            dist.all_gather(parts, raw, group=self.group)
            return torch.cat(parts, dim=dim % t.dim()).view(t.dtype)
        out = torch.cat(ring.parts(t), dim=dim)
        ring.finish()
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """The model axis' exchange of ``t``'s leading (tp) slots, as
        ``jax.lax.all_to_all(t, axis, 0, 0, tiled=False)``: this rank (r)
        sends ``t[j]`` to model rank j and receives rank j's ``t[r]`` into
        slot j. Through the ring every rank writes its whole ``t`` once
        and reads slot r of each peer's; under NCCL,
        ``all_to_all_single`` (raw bytes: exact for every dtype)."""
        if self.tp == 1:
            return t
        if t.shape[0] != self.tp:
            raise ValueError(f"all_to_all of a {tuple(t.shape)} tensor: "
                             f"its leading dim must be tp={self.tp}")
        ring = self._ring(t)
        if ring is None:
            raw = t.contiguous().view(torch.uint8)
            out = torch.empty_like(raw)
            dist.all_to_all_single(out, raw, group=self.group)
            return out.view(t.dtype)
        parts = ring.parts(t)
        r = self.model_rank
        out = torch.stack([p[r] for p in parts])
        ring.finish()
        return out

    @contextlib.contextmanager
    def _mesh_parts(self, t: Optional[torch.Tensor], shape, dtype, device):
        """Every mesh rank's part of ``shape`` and ``dtype`` on ``device``,
        by global rank, valid inside the block; a rank passing ``t`` None
        posts nothing, and its part is not to be read."""
        ranks = self.mesh.ranks
        if self.backend == "nccl":
            # each rank's own card; a host part goes there and back
            card = torch.device("cuda", torch.cuda.current_device())
            n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            mine = (torch.zeros(n, dtype=torch.uint8, device=card)
                    if t is None else
                    t.contiguous().reshape(-1).view(torch.uint8).to(card))
            every = [torch.empty_like(mine) for _ in ranks]
            dist.all_gather(every, mine, group=self.mesh_group)
            yield {r: p.view(dtype).view(shape).to(device)
                   for r, p in zip(ranks, every)}
            return
        ring = _exchange("tensors", ranks, self.mesh_group,
                         torch.device(device))
        like = torch.empty(shape, dtype=dtype, device="meta") \
            if t is None else t
        parts = ring.parts(like, write=t is not None)
        try:
            yield dict(zip(ranks, parts))
        finally:
            ring.finish()

    def gather_whole(self, part: Optional[torch.Tensor],
                     senders: Sequence[int], receivers: Sequence[int],
                     shape, dtype, axis: Optional[int], device,
                     keep: Optional[Tuple[int, int, int]] = None
                     ) -> Optional[torch.Tensor]:
        """A tensor held in slices, made whole on ``receivers``: each of
        ``senders`` (global ranks of the mesh, in slice order) holds its
        slice ``part`` of ``shape`` (every other rank passes None), and
        the whole is the slices concatenated along ``axis`` (None: each
        sender holds the whole, and the first's is taken). ``keep`` =
        (dim, lo, hi): a receiver gets only the whole's [lo, hi) along
        ``dim`` (``axis`` itself where the slices are split), the rest
        never copied. Every rank of the mesh takes part. The slices move
        as raw bytes (exact for every dtype) in pieces of at most
        ``CHUNK_BYTES`` along dim 0, so the exchange's buffers stay small
        whatever the tensor. Returns the whole (or its kept part) on
        ``device`` on a receiver, None elsewhere."""
        shape = tuple(shape)
        srcs = list(senders) if axis is not None else list(senders)[:1]
        full = list(shape)
        if axis is not None:
            full[axis] *= len(srcs)
        d = axis if axis is not None else 0
        d, lo, hi = keep if keep is not None else (d, 0, full[d])
        if axis is not None and d != axis:
            raise ValueError(f"keep along dim {d} of slices split on {axis}")
        kept = list(full)
        kept[d] = hi - lo
        out = torch.empty(kept, dtype=dtype, device=device) \
            if self.rank in receivers else None
        row = max(1, math.prod(shape[1:])
                  * torch.empty((), dtype=dtype).element_size())
        step = max(1, CHUNK_BYTES // row)
        for i0 in range(0, shape[0], step):
            i1 = min(shape[0], i0 + step)
            mine = part[i0:i1] if part is not None \
                and self.rank in srcs else None
            with self._mesh_parts(mine, (i1 - i0, *shape[1:]), dtype,
                                  device) as parts:
                if out is None:
                    continue
                for j, s in enumerate(srcs):
                    # the piece's place in the whole: its first row, and
                    # its first index and extent along d
                    row0 = i0 + (j * shape[0] if axis == 0 else 0)
                    at = j * shape[d] if axis == d and d != 0 else 0
                    ext = shape[d] if axis == d else full[d]
                    if d == 0:
                        a, b = max(row0, lo), min(row0 + i1 - i0, hi)
                        if a < b:
                            out[a - lo:b - lo].copy_(
                                parts[s][a - row0:b - row0])
                        continue
                    a, b = max(at, lo), min(at + ext, hi)
                    if a < b:
                        out[row0:row0 + i1 - i0].narrow(d, a - lo, b - a) \
                            .copy_(parts[s].narrow(d, a - at, b - a))
        return out

    def mean_all(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over every rank of the mesh, each axis of
        ``all_axes`` in turn (the reference's ``pmean`` over each), the
        same bits on every rank."""
        if self.mesh.size == 1:
            return t
        ranks = self.mesh.ranks           # the mesh's ranks, row-major
        if self.backend == "nccl":
            every = [torch.empty_like(t) for _ in ranks]
            dist.all_gather(every, t.contiguous(), group=self.mesh_group)
            parts = every
        else:
            ring = _exchange("tensors", ranks, self.mesh_group, t.device)
            parts = [p.clone() for p in ring.parts(t)]
            ring.finish()
        grid = torch.stack(parts).reshape(*self.mesh.devices.shape, *t.shape)
        for ax in self.all_axes:
            grid = grid.mean(dim=self.mesh.axis_names.index(ax),
                             keepdim=True)
        return grid.reshape(t.shape)

    def gather_object(self, obj: Any) -> List[Any]:
        """Every mesh rank's ``obj``, in the mesh's rank order."""
        if self.mesh.size == 1:
            return [obj]
        return _exchange("objects", self.mesh.ranks,
                         self.mesh_group).all_gather(obj)

    def broadcast_object(self, obj: Any) -> Any:
        """The lead's ``obj`` (the mesh's first rank), on every rank of the
        mesh: a host decision every rank must take alike."""
        return self.gather_object(obj if self.rank == self.lead
                                  else None)[0]

    def share(self, value, what: str):
        """A readback of the mesh, on every rank of the process group: each
        rank of the mesh passes its host array ``value``, every other rank
        None. Every rank checks the mesh's arrays equal (what each member
        computed must agree, or the schedulers would drift apart) and
        returns the lead's, so a rank outside the mesh takes the mesh's
        host decisions from it. One exchange of host objects: the lead
        sends the array, the other members its crc32."""
        if world_size() == 1:
            return value
        mine = None
        if self.member:
            crc = zlib.crc32(np.ascontiguousarray(value).tobytes())
            mine = (crc, value if self.rank == self.lead else None)
        seen = _exchange("objects", list(range(world_size())),
                         None).all_gather(mine)
        crcs = [seen[r][0] for r in self.mesh.ranks]
        if len(set(crcs)) > 1:
            raise RuntimeError(f"{what} differs between the ranks of "
                               f"{self.mesh}: crc32 {crcs}")
        return value if self.rank == self.lead else seen[self.lead][1]


_CONTEXTS: Dict[Any, ParallelContext] = {}


def make_context(mesh: Mesh, data_axes: Optional[Sequence[str]] = None
                 ) -> ParallelContext:
    """This rank's context on ``mesh``: every axis but "model" is a data
    axis, as in the reference. A rank outside the mesh gets a context
    whose ``member`` is False. A mesh of more than one rank needs the
    process group, and every rank of the group must make the context of
    the same mesh at the same point, members or not: a model-axis row
    and a mesh that are not the whole group get process groups of their
    own, which all ranks create together (a fleet makes the contexts of
    all its submeshes at once). One context a mesh and process: later
    calls return it."""
    if data_axes is None:
        data_axes = tuple(a for a in mesh.axis_names if a != "model")
    key = (mesh, tuple(data_axes), world_size())
    if key in _CONTEXTS:
        return _CONTEXTS[key]
    rank, world = global_rank(), world_size()
    if not set(mesh.ranks) <= set(range(world)):
        raise ValueError(f"{mesh} names ranks outside the {world}-rank "
                         "process group")
    group = mesh_group = None
    backend = ""
    if mesh.size > 1:
        if not (dist.is_initialized() and _RANK):
            raise RuntimeError(f"{mesh} spans {mesh.size} ranks: run it in "
                               "ranks that launch_ranks started (serve.py "
                               "--mesh / --tp do)")
        whole = sorted(mesh.ranks) == list(range(world))
        rows = mesh.devices.reshape(-1, mesh.shape["model"])
        if len(rows) > 1 or not whole:
            for row in rows:      # every rank creates every row's group
                g = dist.new_group([int(r) for r in row])
                if rank in row:
                    group = g
        if not whole:
            mesh_group = (dist.new_group(mesh.ranks) if len(rows) > 1
                          else group)
        backend = dist.get_backend()
    ctx = ParallelContext(mesh=mesh, data_axes=tuple(data_axes), rank=rank,
                          group=group, backend=backend, mesh_group=mesh_group)
    _CONTEXTS[key] = ctx
    return ctx


def world_context() -> ParallelContext:
    """The context of every rank of the process group, one (1, world)
    mesh: the ranks a fleet's host decisions, readbacks and reshards are
    shared over. It makes no process group of its own, so any rank may
    make it at any point."""
    n = world_size()
    return make_context(Mesh(np.arange(n).reshape(1, n), ("data", "model")))


# -- ranks --------------------------------------------------------------------
def _rank_entry(rank: int, fn, world: int, where: str, backend: str,
                device: str, timeout_s: float, threads, args) -> None:
    if threads:
        torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(where, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    _RANK.update(dir=where, timeout=timeout_s)
    out = fn(rank, dev, *args)
    with open(os.path.join(where, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    # a rank that raised keeps its group until it exits, after its error
    # is recorded: the peers' collectives then fail behind its error
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()                 # no peer still reads this rank's buffers
    _EXCHANGES.clear()
    dist.destroy_process_group()
    _CONTEXTS.clear()


def launch_ranks(fn: Callable, world: int, args: Sequence = (), *,
                 device: str = "cuda", timeout_s: float = 600.0,
                 threads: Optional[int] = None, quiet: bool = False
                 ) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in ``world`` spawned processes
    joined by one process group (a file store in a fresh temporary
    directory, which also holds the ranks' shared exchange files: no
    network), and return each rank's result in rank order. ``fn`` must
    be importable by module path and its results picklable (move tensors
    to the CPU). Collectives time out after ``timeout_s``; when any rank
    raises, the others are terminated and the error is raised here (the
    join never waits on a rank stuck in a collective). ``threads`` sets
    each rank's intra-op threads (by default the host's cores split
    between the ranks: spinning thread pools that oversubscribe the
    cores slowed CPU ranks tenfold). Prints the backend and why, unless
    ``quiet``."""
    backend, why = choose_backend(device, world)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    if not quiet:
        print(f"ranks: {world} over {backend} ({why})")
    where = tempfile.mkdtemp(prefix="repro-ranks-")
    try:
        torch.multiprocessing.start_processes(
            _rank_entry, args=(fn, world, where, backend, device, timeout_s,
                               threads, tuple(args)),
            nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(where, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(where, ignore_errors=True)
