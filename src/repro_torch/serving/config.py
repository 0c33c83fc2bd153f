"""Unified serving configuration (DESIGN.md §Serving API).

Eight PRs of feature growth left ``InferenceEngine.__init__`` with 16
keyword knobs, ``FleetRuntime`` re-declaring most of them, and
``TwoPoolRuntime`` silently dropping the overload-survival ones — the
classic kwarg-sprawl failure mode where a forgotten passthrough turns
a feature off without a trace.  :class:`ServingConfig` is the single
validated object every serving constructor accepts instead:

    cfg = ServingConfig(paged=True, decode_k=8, preemption=True)
    eng = InferenceEngine(model_cfg, params, n_max, c_max, config=cfg)
    rt  = FleetRuntime(model_cfg, params, ..., config=cfg)

Legacy keyword arguments keep working through a thin shim: every
serving constructor folds explicit kwargs into the config via
:meth:`ServingConfig.replace`, so ``InferenceEngine(..., paged=True)``
and ``InferenceEngine(..., config=ServingConfig(paged=True))`` build
bitwise-identical engines (test-pinned in tests/test_serving_config.py,
which also asserts every field REACHES the constructed engines — the
regression guard for the dropped-knob bug class).

Scope: the fields are the per-engine serving knobs plus the two
fleet-level placement/routing switches (``tp_degree``,
``lout_routing``) that ride along so one object configures the whole
stack.  Gateway topology (boundaries, gammas, slot counts) stays a
runtime argument — it comes from the *plan*, not from configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.profiles import DEFAULT_KV_BLOCK
from repro_torch.serving.draft import DEFAULT_NGRAM as DEFAULT_SPEC_NGRAM

# legacy kwarg spellings accepted by the constructor shims
_ALIASES = {"kv_block_size": "block_size"}

# "kernel": the hand-written CUDA decode kernels (kernels/ops.py picks the
# plain PyTorch version for CPU tensors); "torch": the gather + _sdpa path
_VALID_DECODE_IMPLS = ("kernel", "torch")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """All serving knobs in one frozen, validated object.

    Field groups (each references its DESIGN.md section):

    * engine step shape: ``c_chunk``, ``eos_id``, ``decode_impl``
      (§Engine), ``decode_k`` (§Engine hot path), ``spec_k`` /
      ``spec_ngram`` (§Speculative decoding)
    * KV layout: ``paged``, ``block_size``, ``num_blocks``,
      ``prefix_cache`` (§Paged KV cache, §Prefix caching)
    * overload survival: ``preemption``, ``max_queue_wait``,
      ``swap_threshold``, ``hol_window`` (§Overload survival)
    * placement: ``mesh``, ``parallel``, ``tp_degree``
      (§Sharded serving)
    * output-length awareness (§Serving API): ``lout_reservation``
      tightens the paged worst-case block reservation to the request's
      predicted output length (needs ``paged`` + ``preemption`` — the
      preemption machinery is the safety net when a prediction runs
      short); ``lout_routing`` lets the gateway route by predicted
      rather than worst-case output length, clamping the generation
      budget to the chosen pool's context (token-budget routing).
    * live re-provisioning (§Live re-provisioning & fault injection):
      ``autoscale`` arms the re-planner's hardware path — tick deltas
      beyond hysteresis trigger ``FleetRuntime.reprovision``.
    """

    # -- engine step shape -------------------------------------------------
    c_chunk: int = 512
    eos_id: Optional[int] = None
    decode_impl: str = "kernel"
    decode_k: int = 1
    spec_k: int = 1
    spec_ngram: int = DEFAULT_SPEC_NGRAM
    # -- KV layout ---------------------------------------------------------
    paged: bool = False
    block_size: int = DEFAULT_KV_BLOCK
    num_blocks: Optional[int] = None
    prefix_cache: bool = False
    # -- overload survival -------------------------------------------------
    preemption: bool = False
    max_queue_wait: Optional[float] = None
    swap_threshold: Optional[int] = None
    hol_window: int = 2
    # -- placement ---------------------------------------------------------
    mesh: Any = None
    parallel: Any = None
    tp_degree: int = 1
    # -- output-length awareness -------------------------------------------
    lout_reservation: bool = False
    lout_routing: bool = False
    # -- live re-provisioning (§Live re-provisioning & fault injection) ----
    # let the re-planner ACT on context/GPU-count recommendations
    # beyond its hysteresis threshold by live-rebuilding pools
    # (FleetRuntime.reprovision: zero-drop KV migration) instead of
    # only reporting them
    autoscale: bool = False

    def __post_init__(self):
        def bad(msg):
            raise ValueError(f"ServingConfig: {msg}")
        if self.c_chunk < 1:
            bad(f"c_chunk must be >= 1, got {self.c_chunk}")
        if self.decode_impl not in _VALID_DECODE_IMPLS:
            bad(f"decode_impl must be one of {_VALID_DECODE_IMPLS}, "
                f"got {self.decode_impl!r}")
        if self.decode_k < 1:
            bad(f"decode_k must be >= 1, got {self.decode_k}")
        if self.spec_k < 1:
            bad(f"spec_k must be >= 1, got {self.spec_k}")
        if self.spec_ngram < 1:
            bad(f"spec_ngram must be >= 1, got {self.spec_ngram}")
        if self.block_size < 1:
            bad(f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks is not None and self.num_blocks < 1:
            bad(f"num_blocks must be >= 1, got {self.num_blocks}")
        if self.prefix_cache and not self.paged:
            bad("prefix_cache=True needs paged=True (block granularity "
                "is what gets shared)")
        if self.max_queue_wait is not None and self.max_queue_wait <= 0:
            bad(f"max_queue_wait must be > 0 iterations, "
                f"got {self.max_queue_wait}")
        if self.swap_threshold is not None and self.swap_threshold < 0:
            bad(f"swap_threshold must be >= 0 tokens, "
                f"got {self.swap_threshold}")
        if self.hol_window < 0:
            bad(f"hol_window must be >= 0, got {self.hol_window}")
        if self.tp_degree < 1:
            bad(f"tp_degree must be >= 1, got {self.tp_degree}")
        if self.tp_degree > 1 and self.mesh is None:
            bad("tp_degree > 1 needs a mesh to carve replica submeshes "
                "from")
        if self.lout_reservation and not (self.paged and self.preemption):
            bad("lout_reservation=True needs paged=True and "
                "preemption=True (preemption is the safety net when a "
                "request outruns its predicted output length)")

    def replace(self, **overrides) -> "ServingConfig":
        """New config with ``overrides`` applied (legacy kwarg aliases
        accepted); re-validates, so an invalid combination fails here
        rather than deep inside an engine constructor."""
        clean = {}
        for key, val in overrides.items():
            key = _ALIASES.get(key, key)
            if key not in _FIELD_NAMES:
                raise TypeError(
                    f"unknown serving option {key!r}; valid options: "
                    f"{sorted(_FIELD_NAMES)}")
            clean[key] = val
        if not clean:
            return self
        return dataclasses.replace(self, **clean)

    @classmethod
    def from_kwargs(cls, **kwargs) -> "ServingConfig":
        """Build a config from legacy keyword arguments (the shim every
        serving constructor routes through)."""
        return cls().replace(**kwargs)


_FIELD_NAMES = frozenset(f.name for f in dataclasses.fields(ServingConfig))


def field_names() -> frozenset:
    """All ServingConfig field names (for the reach-every-engine
    regression test: a new field must be added to the test's mapping
    before the suite passes)."""
    return _FIELD_NAMES
