"""Prints the bf16 drift of the recurrent families, the port's beside
the JAX package's, on the CPU: the figures tests/test_torch_ssm_bf16.py
holds (the blocks and the reduced models), and with ``--published`` the
same model figures at xlstm-350m's and zamba2-1.2b's published widths
with the depth cut to each given number of layers (prompt 256, one scan
chunk, then 6 tokens; batch 2). Every figure is a distance as a share
of the reference's max|.| (the blocks' "ulps": in bf16 ulps of it).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/ssm_bf16_drift.py \\
        [--published 4 8]

A 16-layer xlstm at the published widths holds about 2 GB of weights
in the two packages' f32 and bf16 copies, and runs a few minutes.
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_ssm_bf16 as T  # noqa: E402


def _show(what, r):
    print(f"{what}: " + "; ".join(f"{k} {v:.4g}" for k, v in r.items()),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--published", type=int, nargs="*", default=[],
                    help="depths to read at the published widths")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for kind in T.JAX_FNS:
        block = T.make_block(kind)
        for t in (16, 64):
            _show(f"{kind} T={t}", T.block_readings(block, t))
    for v, (name, kw) in T.VARIANTS.items():
        _show(f"{v} (reduced)", T.model_readings(T.model_runs(name, **kw)))
    for layers in args.published:
        for name in ("xlstm-350m", "zamba2-1.2b"):
            runs = T.model_runs(name, prompt=256, new=6, batch=2,
                                reduced=False, num_layers=layers)
            _show(f"{name} published widths, {layers} layers",
                  T.model_readings(runs))


if __name__ == "__main__":
    main()
