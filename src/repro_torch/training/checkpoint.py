"""Minimal checkpointing: params / optimizer-state trees -> a flat .npz
of leaves plus a JSON manifest, in the JAX package's format
(``repro/training/checkpoint.py``), so each package restores the
other's checkpoints.

  ckpt_{step:08d}.npz   leaf_0 ... leaf_{n-1}, in ``jax.tree`` leaf
                        order (training/tree.py): {"opt": AdamWState,
                        "params": ...} puts the optimizer state first
  ckpt_{step:08d}.json  {"step", "treedef", "n_leaves"}; "treedef"
                        describes the tree and is never read back

numpy has no bfloat16, and ``np.savez`` stores the JAX package's
bfloat16 leaves as 2-byte voids ('<V2') holding the bits: a bfloat16
tensor is written the same way, byte for byte, and read back bit for
bit. Tensors are saved from any device and restored onto the device and
dtype of the ``like`` tree's leaves.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.training import tree

# the .npy header np.savez gives a JAX bfloat16 leaf
BF16_DESCR = "<V2"


def _write_leaf(f, leaf: torch.Tensor) -> None:
    t = leaf.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        np.lib.format.write_array(f, t.numpy(), allow_pickle=False)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": BF16_DESCR, "fortran_order": False,
            "shape": tuple(t.shape)})
    f.write(t.view(torch.int16).numpy().tobytes())


def save(path: str, step: int, params, opt_state=None) -> None:
    os.makedirs(path, exist_ok=True)
    payload = {"params": params}
    if opt_state is not None:
        payload["opt"] = opt_state
    leaves = tree.leaves(payload)
    name = os.path.join(path, f"ckpt_{step:08d}")
    with zipfile.ZipFile(name + ".npz", "w", zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for i, leaf in enumerate(leaves):
            with z.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                _write_leaf(f, leaf)
    with open(name + ".json", "w") as f:
        json.dump({"step": step,
                   "treedef": str(tree.unflatten(payload,
                                                 ["*"] * len(leaves))),
                   "n_leaves": len(leaves)}, f)


def latest_step(path: str) -> int:
    if not os.path.isdir(path):
        return -1
    steps = [int(f[5:13]) for f in os.listdir(path)
             if f.startswith("ckpt_") and f.endswith(".npz")]
    return max(steps) if steps else -1


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:    # bfloat16 bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def restore(path: str, step: int, like) -> Any:
    """``like``: a tree with the target structure (params or
    {"params":..., "opt":...}) whose leaves give each restored tensor's
    device and dtype."""
    leaves = tree.leaves(like)
    with np.load(os.path.join(path, f"ckpt_{step:08d}.npz")) as data:
        if len(leaves) != len(data.files):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                             f"expected {len(leaves)}")
        new = [_to_tensor(data[f"leaf_{i}"], l)
               for i, l in enumerate(leaves)]
    return tree.unflatten(like, new)
