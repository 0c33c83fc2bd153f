"""Times the collectives of four ranks on one card (run on a CUDA host,
not collected by pytest):

    PYTHONPATH=src python3 tests/tp_collective_probe.py [--ranks 4]

For a decode step's partial product (4, 1, 4096), a prefill chunk's
(4, 256, 4096) and a batch prefill's (8, 2048, 4096), all bf16, prints
each rank's milliseconds a call of: gloo's all-reduce of a host tensor,
the host-staged all-reduce (copy to the host, gloo, copy back), the
port's ``ParallelContext.all_reduce_sum`` and ``all_gather`` (the card
buffers shared between the ranks), a barrier and a broadcast of a host
object; and checks that the port's sum is the same bits on every rank,
equal to the rank-order f32 sum of the ranks' inputs. These are the
readings behind ``distributed/context.py``'s exchange through shared
memory."""
import argparse
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.distributed import context as PC
from repro_torch.launch.mesh import make_smoke_mesh

SHAPES = {"decode": (4, 1, 4096), "chunk": (4, 256, 4096),
          "prefill": (8, 2048, 4096)}


def _part(rank, shape, dev):
    g = torch.Generator(device=dev).manual_seed(rank)
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


def probe(rank, dev, ranks):
    ctx = PC.make_context(make_smoke_mesh(ranks))
    out = {}
    for name, shape in SHAPES.items():
        x = _part(rank, shape, dev)
        host = x.float().cpu()
        n = 3 if name == "prefill" else 30

        def timed(fn):
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return round(1e3 * (time.perf_counter() - t0) / n, 3)

        def staged():
            h = x.float().cpu()
            dist.all_reduce(h)
            return h.to(dev)
        got = ctx.all_reduce_sum(x)
        want = _part(0, shape, dev).float()
        for r in range(1, ranks):
            want += _part(r, shape, dev).float()
        gathered = ctx.all_gather(x, -1)
        out[name] = dict(
            gloo_host=timed(lambda: dist.all_reduce(host.clone())),
            staged=timed(staged),
            ring_sum=timed(lambda: ctx.all_reduce_sum(x)),
            ring_gather=timed(lambda: ctx.all_gather(x, -1)),
            barrier=timed(dist.barrier),
            object=timed(lambda: ctx.broadcast_object(("decision", 1))),
            exact=bool(torch.equal(got, want.to(torch.bfloat16))),
            gather_ok=bool(torch.equal(
                gathered.chunk(ranks, -1)[rank], x)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    res = PC.launch_ranks(probe, args.ranks, (args.ranks,), device="cuda")
    for r, o in enumerate(res):
        print(f"rank {r}: {o}")
    if not all(v["exact"] and v["gather_ok"] for o in res
               for v in o.values()):
        sys.exit("a collective gave other bits than the rank-order sum")


if __name__ == "__main__":
    main()
