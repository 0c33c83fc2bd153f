"""Training launcher on one GPU: the port of ``repro/launch/train.py``
without sharding. Runs AdamW train steps (layer remat) on synthetic
token data and prints the JAX launcher's lines. A model with a frontend
(VLM, ENCDEC) gets the JAX launcher's stub in every batch, ``ones((
global_batch, frontend_tokens, d_model)) * 0.01`` in the model dtype.

  # reduced minitron-8b (f32) on the CPU, 10 steps
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 10 \
      --device cpu

  # the same on the card, with a checkpoint of the final parameters
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 10 \
      --ckpt-dir /tmp/ckpt

Full-width minitron-8b does not fit one 80 GB card for training (its
bf16 weights and grads plus the float32 AdamW moments come to ~93 GB);
``chip_smoke.py`` passes :func:`train` a depth-cut config instead.
Runs on ``--device cuda`` (the default) and raises when no card is
present; ``--mesh`` takes one device only.
"""
import argparse
import dataclasses
import time
from typing import Any, Dict, List

import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.context import SLICE_TRAIN
from repro_torch.models import model as M
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.data import DataConfig, batch_at
from repro_torch.training.optimizer import AdamWConfig, init_adamw
from repro_torch.training.train_step import make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--mesh", default="",
                    help="DATAxMODEL; one device only: '' or 1x1")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--zero1", action="store_true",
                    help="shard AdamW m/v over the data axes (ZeRO-1); "
                         "nothing to shard on one device")
    ap.add_argument("--no-sequence-parallel", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` did: the trained ``params`` and ``opt`` state,
    each step's loss and grad norm, and each step's host-clock seconds
    (the step ends in the loss's copy to the host, so the device is
    synchronised)."""
    cfg: Any
    params: Dict[str, Any]
    opt: Any
    losses: List[float]
    gnorms: List[float]
    step_s: List[float]


def train(args, params=None, cfg=None, log=print) -> TrainRun:
    """``args.steps`` train steps on ``batch_at(seed 0)`` batches (with
    the frontend stub where ``cfg.frontend_tokens`` is set). ``cfg``
    defaults to ``--arch`` (reduced in f32 with ``--reduced``);
    ``params`` to ``init_params(cfg, seed=0)`` on the device. A caller
    may pass its own (the tests pass the JAX launcher's weights, the
    smoke a depth-cut config)."""
    if args.mesh not in ("", "1x1"):
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is a later slice of the "
            f"PyTorch port (one device only: --mesh 1x1); it comes with "
            f"{SLICE_TRAIN}")
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    log(f"mesh 1x1 (1 devices), arch={cfg.name}")
    if params is None:
        params = M.init_params(cfg, seed=0, device=device)
    opt = init_adamw(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                          total_steps=args.steps)
    step_fn = make_train_step(
        cfg, opt_cfg, remat="layer", microbatches=args.microbatches,
        sequence_parallel=not args.no_sequence_parallel)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch)
    frontend = None
    if cfg.frontend_tokens:
        frontend = torch.ones(
            (args.global_batch, cfg.frontend_tokens, cfg.d_model),
            dtype=params["embed"].dtype, device=device) * 0.01
    run = TrainRun(cfg, params, opt, [], [], [])
    t0 = time.time()
    for i in range(args.steps):
        t1 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in batch_at(dc, i).items()}
        if frontend is not None:
            batch["frontend"] = frontend
        run.params, run.opt, metrics = step_fn(run.params, run.opt, batch)
        run.losses.append(float(metrics["loss"]))
        run.gnorms.append(float(metrics["grad_norm"]))
        run.step_s.append(time.perf_counter() - t1)
        log(f"step {i:3d} loss={run.losses[-1]:.4f} "
            f"gnorm={run.gnorms[-1]:.2f} "
            f"({(time.time()-t0)/(i+1):.2f}s/step)")
    if args.ckpt_dir:
        CKPT.save(args.ckpt_dir, args.steps, run.params)
        log(f"saved checkpoint to {args.ckpt_dir}")
    return run


def main():
    train(parse_args(), log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
