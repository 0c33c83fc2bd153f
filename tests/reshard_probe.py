"""Times ``ParallelContext.gather_whole`` over four ranks on one card, as a
weight reshard between submeshes runs it (run on a CUDA host, not
collected by pytest):

    PYTHONPATH=src python3 tests/reshard_probe.py

A bf16 leaf of minitron-8b's MLP width, (32, 4096, 16384), is held in two
slices along its last dim by ranks 2 and 3 (a tp=2 submesh) and made
whole: "one keeps" on rank 1 alone, which keeps every whole it receives
(a move to tp=1: each call allocates a new 4.3 GB tensor), "one reuses"
on rank 1 alone, the whole freed after each call, and "all" on every
rank, freed after each call (a move to tp=4). Prints each rank's
seconds a call and per 64 MiB piece, and checks each whole against the
slices it was made from. Then ``reconfigure.reshard_params`` moves
minitron-8b's weights (bf16, seed 0) from ranks 2-3 (tp=2, each rank
drawing its shard) to rank 1 (tp=1), as phase 20 (c) does inside a
serving run: its seconds, each leaf's ``gather_whole`` seconds (the
device synchronised around each), and whether rank 1's copy equals the
unsharded draw's leaves."""
import argparse
import sys
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.distributed import context as PC
from repro_torch.launch.mesh import make_submeshes, parse_mesh
from repro_torch.models import model as M
from repro_torch.serving import reconfigure
from repro_torch.training import tree

SHAPE = (32, 4096, 16384)
SENDERS = [2, 3]
CASES = (("one keeps", [1], True), ("one reuses", [1], False),
         ("all", [0, 1, 2, 3], False))


def probe(rank, dev, calls):
    world = PC.world_context()
    half = (*SHAPE[:2], SHAPE[2] // len(SENDERS))
    part = None
    if rank in SENDERS:
        g = torch.Generator(device=dev).manual_seed(rank)
        part = torch.randn(half, generator=g, device=dev).to(torch.bfloat16)
    pieces = -(-SHAPE[0] // max(1, PC.CHUNK_BYTES // (
        half[1] * half[2] * 2)))
    out, kept = {}, []
    for name, receivers, keep in CASES:
        secs = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole = world.gather_whole(part, SENDERS, receivers, half,
                                       torch.bfloat16, 2, dev)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if whole is not None and rank in SENDERS:
                j = SENDERS.index(rank)
                mine = whole[..., j * half[2]:(j + 1) * half[2]]
                if not torch.equal(mine, part):
                    raise RuntimeError(f"{name}: rank {rank}'s slice differs")
            if keep and whole is not None:
                kept.append(whole)
            del whole
        out[name] = [round(s, 4) for s in secs]
        out[name + " per piece ms"] = round(
            1e3 * min(secs) / pieces, 3)
    kept.clear()
    torch.cuda.empty_cache()
    out.update(_reshard(rank, dev))
    return out


def _reshard(rank, dev):
    """minitron-8b's weights from the tp=2 submesh [2, 3] to [1]."""
    mesh = parse_mesh("1x4")
    subs = [PC.make_context(m) for m in make_submeshes(mesh, 2)]
    ones = [PC.make_context(m) for m in make_submeshes(mesh, 1)]
    cfg = get_config("minitron-8b")
    own = next(c for c in subs if c.member)
    params = M.init_params(cfg, seed=0, device=dev, parallel=own)
    world, leaf_s = PC.world_context(), []
    gather = PC.ParallelContext.gather_whole

    def timed(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = gather(self, *a, **kw)
        torch.cuda.synchronize()
        leaf_s.append(round(time.perf_counter() - t0, 4))
        return whole
    torch.cuda.synchronize()
    world.gather_object(None)
    t0 = time.perf_counter()
    PC.ParallelContext.gather_whole = timed
    try:
        new = reconfigure.reshard_params(
            params if rank in (2, 3) else None, subs[1].mesh, ones[1].mesh,
            dev)
    finally:
        PC.ParallelContext.gather_whole = gather
    torch.cuda.synchronize()
    out = {"reshard s": round(time.perf_counter() - t0, 4),
           "leaves s": leaf_s}
    del params                   # room on the card for the check's draw
    torch.cuda.empty_cache()
    world.gather_object(None)
    if new is not None:
        full = M.init_params(cfg, seed=0, device=dev)
        out["equal"] = all(torch.equal(a, b) for a, b in zip(
            tree.leaves(new), tree.leaves(full)))
    world.gather_object(None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("reshard_probe: no CUDA device", file=sys.stderr)
        return 2
    res = PC.launch_ranks(probe, 4, (args.calls,), device="cuda")
    print(torch.cuda.get_device_name(0))
    for rank, r in enumerate(res):
        print(f"rank {rank}: {r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
