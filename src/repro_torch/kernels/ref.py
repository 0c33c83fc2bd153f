"""Plain PyTorch oracles for every kernel, under the JAX package's names
(``repro/kernels/ref.py``): each is the kernel module's own plain version,
which the CUDA kernel is held against. The plain versions take the
reference's argument lists (and an optional trailing ``active`` mask)."""
from __future__ import annotations

from repro_torch.kernels.gqa_decode import gqa_decode_plain
from repro_torch.kernels.paged_decode import paged_gqa_decode_plain
from repro_torch.kernels.textrank import textrank_plain

gqa_decode_ref = gqa_decode_plain
paged_gqa_decode_ref = paged_gqa_decode_plain
textrank_ref = textrank_plain
