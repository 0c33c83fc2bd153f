"""Prints the VLM family's bf16 drift, the port's beside the JAX
package's, on the CPU: the figures tests/test_torch_vlm_bf16.py holds
(reduced llama-3.2-vision-11b, gates 0.5 / -0.7), and with ``--depths``
the same model figures at the reduced widths with the published
structure (a cross layer after every 5 decoder layers) cut to each
given depth. Every figure is a distance as a share of the reference's
max|.| (the block's "ulps": in bf16 ulps of it).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/vlm_bf16_drift.py \\
        [--depths 5 10 20 40]

The published widths do not fit this check: one group of
llama-3.2-vision-11b (5 decoder layers, a cross layer, the embedding and
the head) is 2.4e9 parameters, ~19 GB in the two packages' bf16 and f32
copies.
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_vlm_bf16 as T  # noqa: E402


def _show(what, r):
    print(f"{what}: " + "; ".join(f"{k} {v:.4g}" for k, v in r.items()),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", type=int, nargs="*", default=[],
                    help="decoder depths at the published structure")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for v, kw in T.VARIANTS.items():
        w = T.weights(**kw)
        _show(f"{v} (reduced)", dict(T.block_readings(w),
                                     **T.model_readings(T.model_runs(w))))
    for layers in args.depths:
        w = T.weights(num_layers=layers, cross_attn_every=5)
        _show(f"reduced widths, a cross layer every 5, {layers} layers",
              T.model_readings(T.model_runs(w, prompt=32, new=8, batch=2)))


if __name__ == "__main__":
    main()
