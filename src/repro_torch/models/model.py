"""Model assembly for the dense GQA decoder, the MoE decoder, the
recurrent families (xLSTM, and Zamba2's Mamba2 backbone with a shared
attention block), the VLM and the encoder-decoder, in PyTorch.

The DENSE, MOE (with or without MLA), SSM, HYBRID, VLM and ENCDEC
branches of ``repro/models/model.py``, with the same functional API and
layouts:

  init_params(cfg, seed, device)                           -> params
  forward(params, cfg, batch)                    -> (logits (B, S, V), aux)
  init_cache(cfg, batch, cache_len, device)                -> cache
  prefill(params, cfg, batch)                    -> (last logits, cache)
  init_paged_cache(cfg, num_blocks, block_size, device)    -> cache
  decode_step / prefill_chunk / mixed_step                 -> (logits, cache)
  paged_decode_step / paged_prefill_chunk / paged_mixed_step
  verify_step / paged_verify_step          -> (logits (B, L, V), cache)

Parameters are a nested dict of tensors whose per-layer leaves stay
stacked along a leading layer axis, as in the JAX pytree; layer ``i`` is
``layers[...][i]``. The layer loop is a Python loop (JAX scans it).
Caches are updated in place and returned (models/layers.py). Every dense
entry point takes the int8 KV cache and a sliding window
(``cfg.attention_window``, or the ``window`` argument): the dense cache
is then a ring of min(cache_len, window) entries, and ``prefill_chunk``
/ ``verify_step`` run a masked per-token decode loop instead of the
fused chunk, as in the JAX package. The paged pool is fp and full
attention only, as there. An MoE layer (``cfg.moe``) holds ``moe``
leaves instead of ``mlp`` and runs ``models/moe.py::moe_block`` as its
feed-forward on every path; ``forward`` returns the load-balance losses
summed over layers as its aux, and the other entry points drop them, as
the reference does.

The recurrent families (``models/ssm.py``) keep the reference's layouts:
SSM (xLSTM) stacks each position of ``block_pattern`` on its own
(``layers["blk{i}_{kind}"]``, (n_groups, ...)); HYBRID (Zamba2) stacks
its Mamba2 layers as (n_groups, every, ...) where ``shared_attn_every``
divides the depth and keeps them flat otherwise (grouped at run time,
with a tail of the remaining layers), and applies one weight-shared
attention + MLP block (``shared_attn``) after each group. Their cache
holds the recurrent states under "ssm" in the layer layout and, for
HYBRID, one dense fp KV entry per shared-block application (n_groups,
B, S, Hkv, hd). ``forward`` returns a zero aux; ``prefill_chunk``,
``verify_step`` and ``mixed_step`` take the masked per-token decode
loop; the paged pool refuses both families, with the reference's
reason.

VLM (llama-3.2-vision) interleaves a gated cross-attention layer over a
stubbed frontend (``batch["frontend"]``, (B, F, D) patch embeddings)
after every ``cross_attn_every`` decoder layers. Its parameters keep the
reference's layout: ``layers`` grouped (n_groups, every, ...) and
``cross`` (n_groups, ...) with scalar ``gate`` / ``gate_mlp`` per group
(tanh-gated, zero at init as in the reference, so a fresh cross layer is
the identity). Its cache does not: the self-attention K/V stay flat,
(num_layers, B, S, Hkv, hd) as the dense decoder's, where the reference
groups them (n_groups, every, B, S, ...), so every row mover
(``layers.gather_slot_row``, the engine's host tier, ``_adopt_state``)
and ``decode_index`` find the batch on axis 1 and the row on axis 2
whatever the family; the cross memory's K/V are ``xk`` / ``xv``,
(n_groups, B, F, Hkv, hd), batch on axis 1 too. Decode reads the cached
memory (the reference's decode query carries no ``bq``); the chunk,
verify and mixed steps take the per-token loop; the paged pool refuses
it.

ENCDEC (seamless-m4t) encodes the stubbed frontend (frame embeddings,
``batch["frontend"]``) with a bidirectional stack (``encoder``, RoPE on
the frame positions, no mask, ending in ``enc_ln``); each decoder layer
then adds an ungated cross-attention (``lnx``, ``xattn``) over the
encoder output after its self-attention block. Its cache is the dense
self-attention K/V (int8 and rings as on every dense path) and one cross
K/V entry a layer, ``xk`` / ``xv`` (num_layers, B, F, Hkv, hd), written
by ``prefill``. Unlike the reference, whose ``_fill_cache`` drops int8
on the cross-attention families, an int8 ENCDEC or VLM cache holds its
self-attention K/V quantized. The chunk, verify and mixed steps serve
the engine, which refuses ENCDEC as the reference's does, so they refuse
it too; so does the paged pool.

An MLA model (deepseek-v2, ``cfg.mla``: an MoE decoder whose attention
is ``models/mla.py``'s) runs every dense entry point. Its cache holds the
latent "c_kv" (num_layers, B, S, kv_lora_rank) and the shared rope key
"k_r" (num_layers, B, S, rope_head_dim) under "kv", batch on axis 1 as
every dense cache. ``decode_step`` runs the absorbed decode and ignores
``decode_impl`` (the reference has no kernel for it); the chunk, verify
and mixed steps take the masked per-token loop, as the reference's do.
The paged pool refuses MLA with the reference's words, and so does an
int8 cache: the reference has no int8 latent layout (its ``_fill_cache``
keeps the latent in the model dtype whatever ``kv_cache_dtype`` says),
and the port raises instead of dropping the setting. A prompt longer
than the cache (a ring shorter than the prompt too) is refused with
ValueError, where the reference's ``jnp.pad`` raises on the negative
width.

Tensor parallelism (``parallel=``, a ``distributed.context.
ParallelContext`` whose model axis spans tp ranks; the DENSE decoder and
the MoE decoder without MLA): every entry point, ``init_params`` and the
caches take it. A rank
computes with a local config of H/tp query and Hkv/tp kv heads and d_ff/tp
MLP features (``_local_cfg``) on its shard of the weights
(``distributed/sharding.py::param_specs``: column-parallel q/k/v and
up/gate, row-parallel wo and down); the row-parallel partial products
are summed over the ranks (``ParallelContext.all_reduce_sum``) where the
reference's GSPMD inserts its all-reduce; the embedding is looked up
vocab-parallel (each rank its slab, the rows summed) and the LM head's
logits gathered in rank order, so every rank holds the whole logits.
Each rank's cache is its own, Hkv/tp heads wide, so the decode kernels
run on it unchanged. An MoE layer is expert-parallel
(``moe.moe_block_sharded``: a rank holds E/tp experts, the router and
the shared experts whole) in the reference's mode at each site: "a2a" on
the sequence paths (``forward``, ``prefill``, the fused and the paged
chunk, so verify and mixed), "psum" in ``decode_step`` and
``paged_decode_step`` (so in a window's per-token chunk loop).
``check_supported`` refuses the other families, MLA, and widths or
expert counts tp does not divide, naming the later slice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
from repro_torch.distributed import context as PC
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE_MOD
from repro_torch.models import ssm as S
from repro_torch.training import tree

Params = Dict[str, Any]

RECURRENT = (SSM, HYBRID)
# families whose chunk / verify steps run the masked per-token loop
PER_TOKEN = RECURRENT + (VLM,)
# families with a cross memory ("xk" / "xv" in the cache)
CROSS = (VLM, ENCDEC)


def check_supported(cfg: ModelConfig, paged: bool = False,
                    parallel=None) -> None:
    """Raise NotImplementedError for what the port does not run: on the
    paged pool (``paged``) the recurrent families, VLM, ENCDEC and MLA, a
    window or an int8 cache, which the JAX package refuses there too, for
    the same reasons; under a context whose model axis spans ranks
    (``parallel``), every family but the dense decoder, and widths the
    tp degree does not divide, each naming the later slice that serves
    it."""
    par = _par(parallel)
    if par is not None:
        if cfg.family not in (DENSE, MOE) or cfg.mla is not None:
            what = "MLA" if cfg.mla is not None else "family"
            raise PC.later(f"{what} {cfg.family!r} under tp={par.tp}",
                           PC.SLICE_FAMILIES)
        if cfg.moe is not None and cfg.moe.num_experts % par.tp:
            raise NotImplementedError(
                f"{cfg.moe.num_experts} experts not divisible by "
                f"ep={par.tp}")
        widths = ("num_heads", "num_kv_heads", "vocab_size") \
            + (() if cfg.moe is not None else ("d_ff",))
        odd = [f"{n}={getattr(cfg, n)}" for n in widths
               if getattr(cfg, n) % par.tp]
        if odd:
            raise PC.later(f"tp={par.tp} with {', '.join(odd)} (not "
                           "divisible)", PC.SLICE_FAMILIES)
    if paged and (cfg.family not in (DENSE, MOE) or cfg.mla is not None):
        raise NotImplementedError(
            "paged KV cache supports dense/MoE full-attention models; "
            f"family={cfg.family!r} mla={cfg.mla is not None}")
    if paged and cfg.attention_window:
        raise NotImplementedError(
            "windowed attention already bounds KV by the window; paging "
            "it would page a ring buffer — unsupported")
    if paged and cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("paged KV cache is fp-only for now "
                                  "(int8 scales need a paged layout too)")


def _engine_step(cfg: ModelConfig, name: str, parallel=None) -> None:
    """The chunk, verify and mixed steps serve the engine, which refuses
    ENCDEC as the reference's engine does (the reference reaches these
    steps only through it): refuse them for ENCDEC too."""
    check_supported(cfg, parallel=parallel)
    if cfg.family == ENCDEC:
        raise NotImplementedError(
            f"{name} serves the engine, which supports attention-family "
            "decoders and refuses family 'encdec' (as the reference's "
            "engine does); an encoder-decoder runs forward, prefill and "
            "decode_step")


def _per_token(cfg: ModelConfig, window: Optional[int]) -> bool:
    """Whether the chunk and verify steps take the masked per-token loop:
    the recurrent families, VLM, MLA and any window."""
    return (cfg.family in PER_TOKEN or cfg.mla is not None
            or bool(_window(cfg, window)))


def _par(parallel):
    """``parallel`` when its model axis spans more than one rank, else
    None: a one-rank model axis runs everything local."""
    return parallel if parallel is not None and parallel.tp > 1 else None


@functools.lru_cache(maxsize=None)
def _local_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config one of ``tp`` ranks computes with: its H/tp query and
    Hkv/tp kv heads (q_per_kv and head_dim unchanged) and d_ff/tp MLP
    features; the vocab stays whole (the logits are gathered). An MoE
    config keeps its expert widths and counts (the block splits the
    experts, ``moe.moe_block_sharded``)."""
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        head_dim=cfg.resolved_head_dim,
        d_ff=cfg.d_ff if cfg.moe is not None else cfg.d_ff // tp)


def _local(cfg: ModelConfig, par) -> ModelConfig:
    return cfg if par is None else _local_cfg(cfg, par.tp)


def _sum(par, t):
    """The row-parallel sum of a partial product (``wo``, ``down``)."""
    return t if par is None else par.all_reduce_sum(t)


def _kv_len(cache: Params) -> int:
    """Entries a row of a dense cache holds: axis 2 of any "kv" leaf
    (K/V and their int8 scales, or MLA's latent)."""
    return next(iter(cache["kv"].values())).shape[2]


def _window(cfg: ModelConfig, window: Optional[int]) -> int:
    """The window a call runs: ``window``, or the config's when None (0:
    full attention)."""
    return (cfg.attention_window if window is None else window) or 0


# ===========================================================================
# init
# ===========================================================================
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                parallel=None) -> Params:
    """Random parameters with the JAX package's distributions (embedding
    N(0, 0.02^2), projections N(0, 1/in_dim), ``wo`` at half that std,
    norms at one; an MoE layer's leaves as ``moe.init_moe`` draws them,
    a recurrent layer's as ``ssm.init_*``; a VLM cross layer's gates at
    zero; an ENCDEC model's ``encoder`` stack (no MoE) and ``enc_ln``, and
    ``lnx`` / ``xattn`` in each decoder layer; an MLA layer's ``attn`` as
    ``mla.init_mla`` draws it), in the reference's layout,
    drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``. The numbers differ from JAX's for the same seed; the
    tests carry JAX's parameters across with params.from_jax_numpy. On
    the "meta" device only the shapes are made.

    Under a context whose model axis spans ranks (``parallel``), a rank
    draws every leaf (every embedding slab, every layer's matrix) exactly
    as the unsharded call does and keeps its slice by
    ``sharding.param_specs``: tp ranks start from the weights of one
    device, and a rank holds its shard plus one draw at a time."""
    check_supported(cfg, parallel=parallel)
    par = _par(parallel)
    dtype = L.torch_dtype(cfg.dtype)
    meta = torch.device(device).type == "meta"
    gen = torch.Generator(device="cpu" if meta else device)
    gen.manual_seed(seed)
    n, d = cfg.num_layers, cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def part(*path):
        """(name, full shape) -> this rank's (dim, index, parts) of a leaf
        under ``path`` (None: the whole leaf)."""
        def of(name, shape):
            if par is None:
                return None
            spec = SH.param_spec((*path, name),
                                 torch.empty(shape, device="meta"),
                                 par.model_axis, par.tp)
            dims = [i for i, e in enumerate(spec) if e is not None]
            return (dims[0], par.model_rank, par.tp) if dims else None
        return of

    rows = cfg.vocab_size // (par.tp if par else 1)
    lo_r = par.model_rank * rows if par else 0
    embed = torch.empty((rows, d), dtype=dtype, device=device)
    for lo in range(0, cfg.vocab_size, 1 << 15):   # f32 draws in slabs
        hi = min(cfg.vocab_size, lo + (1 << 15))
        slab = (torch.randn((hi - lo, d), generator=gen, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)
        a, b = max(lo, lo_r), min(hi, lo_r + rows)
        if a < b:
            embed[a - lo_r:b - lo_r] = slab[a - lo:b - lo]
    p: Params = {"embed": embed, "final_ln": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (d, cfg.vocab_size), dtype, device,
                                    part=part()("lm_head",
                                                (d, cfg.vocab_size)))
    if cfg.family == HYBRID:
        n_groups, rem = divmod(n, cfg.ssm.shared_attn_every)
        lead = (n,) if rem else (n_groups, cfg.ssm.shared_attn_every)
        p["layers"] = {"ln": ones(*lead, d),
                       "mamba": S.init_mamba2(gen, cfg, lead, dtype, device)}
        p["shared_attn"] = {"ln1": ones(d),
                            "attn": _init_attention(gen, cfg, (), dtype,
                                                    device),
                            "ln2": ones(d),
                            "mlp": _init_mlp(gen, cfg, (), dtype, device)}
        return p
    if cfg.family == SSM:
        pattern = _pattern(cfg)
        n_groups = n // len(pattern)
        p["layers"] = {
            f"blk{i}_{kind}": {
                "ln": ones(n_groups, d),
                "core": (S.init_mlstm if kind == "mlstm" else S.init_slstm)(
                    gen, cfg, (n_groups,), dtype, device)}
            for i, kind in enumerate(pattern)}
        return p
    lead = (n,)
    if cfg.family == VLM:
        n_groups = n // cfg.cross_attn_every
        lead = (n_groups, cfg.cross_attn_every)
        p["cross"] = {"ln": ones(n_groups, d),
                      "xattn": _init_attention(gen, cfg, (n_groups,), dtype,
                                               device),
                      "gate": torch.zeros(n_groups, dtype=dtype,
                                          device=device),
                      "ln_mlp": ones(n_groups, d),
                      "mlp": _init_mlp(gen, cfg, (n_groups,), dtype, device),
                      "gate_mlp": torch.zeros(n_groups, dtype=dtype,
                                              device=device)}
    if cfg.family == ENCDEC:
        ne = cfg.encoder_layers
        p["encoder"] = {"ln1": ones(ne, d), "ln2": ones(ne, d),
                        "attn": _init_attention(gen, cfg, (ne,), dtype,
                                                device),
                        "mlp": _init_mlp(gen, cfg, (ne,), dtype, device)}
        p["enc_ln"] = ones(d)
    if cfg.mla is not None:
        attn = MLA.init_mla(gen, cfg, lead, dtype, device)
    else:
        attn = _init_attention(gen, cfg, lead, dtype, device,
                               part("layers", "attn"))
    p["layers"] = {"ln1": ones(*lead, d), "ln2": ones(*lead, d),
                   "attn": attn}
    if cfg.moe is not None:
        p["layers"]["moe"] = MOE_MOD.init_moe(gen, cfg, n, dtype, device,
                                              part("layers", "moe"))
    else:
        p["layers"]["mlp"] = _init_mlp(gen, cfg, lead, dtype, device,
                                       part("layers", "mlp"))
    if cfg.family == ENCDEC:
        p["layers"]["lnx"] = ones(n, d)
        p["layers"]["xattn"] = _init_attention(gen, cfg, lead, dtype, device)
    return p


def _whole(name, shape):
    return None


def _init_attention(gen, cfg: ModelConfig, lead, dtype, device,
                    part=_whole) -> Params:
    """Attention projections of ``lead`` stacked layers (``()``: one);
    ``part(name, shape)``: the slice of each leaf to keep
    (``dense_init``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    attn = {}
    for name, shape, scale in (("wq", (*lead, d, h * hd), 1.0),
                               ("wk", (*lead, d, hkv * hd), 1.0),
                               ("wv", (*lead, d, hkv * hd), 1.0),
                               ("wo", (*lead, h * hd, d), 0.5)):
        attn[name] = L.dense_init(gen, shape, dtype, device, scale=scale,
                                  part=part(name, shape))
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            cut = part(name, (*lead, width))
            attn[name] = torch.zeros(
                (*lead, width // (cut[2] if cut else 1)), dtype=dtype,
                device=device)
    return attn


def _init_mlp(gen, cfg: ModelConfig, lead, dtype, device,
              part=_whole) -> Params:
    """MLP of ``lead`` stacked layers: gated unless squared ReLU
    (nemotron has no gate); ``part`` as for :func:`_init_attention`."""
    d, f = cfg.d_model, cfg.d_ff
    names = ("up", "down") if cfg.activation == "squared_relu" \
        else ("up", "gate", "down")
    return {name: L.dense_init(gen, shape, dtype, device,
                               part=part(name, shape))
            for name, shape in ((n, (*lead, f, d) if n == "down"
                                 else (*lead, d, f)) for n in names)}


def _pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    """An SSM config's block kinds, cycled over its layers."""
    return cfg.ssm.block_pattern or ("mlstm",)


def _unstack(stacked) -> List:
    """Per-layer views of a tree (dicts, tuples) of stacked tensors:
    [stacked[..][i]]."""
    flat = [t.unbind(0) for t in tree.leaves(stacked)]
    return [tree.unflatten(stacked, [f[i] for f in flat])
            for i in range(len(flat[0]))]


def _layer_list(params: Params, cfg: ModelConfig) -> List:
    """The decoder layers' per-layer views in order; a VLM's grouped
    (n_groups, every, ...) leaves read group by group."""
    if cfg.family == VLM:
        return [lp for g in _unstack(params["layers"]) for lp in _unstack(g)]
    return _unstack(params["layers"])


def _head(params: Params, cfg: ModelConfig, x, par=None):
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    head = params.get("lm_head")
    return L.lm_head(x, head if head is not None else params["embed"].T,
                     par)


def _ffn_residual(lp, cfg, x, par=None, mode: str = "a2a"):
    """x plus the block's feed-forward (the MLP, or the MoE block) of its
    normed input; and the MoE load-balance loss (None for an MLP). Under
    ``par`` the MLP is column-parallel on up / gate and row-parallel on
    down, whose partial products are summed over the ranks; the MoE
    block is expert-parallel in ``mode`` ("a2a": the sequence paths;
    "psum": the decode steps, as at the reference's sites)."""
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        m, aux = (MOE_MOD.moe_block(lp["moe"], cfg, h) if par is None else
                  MOE_MOD.moe_block_sharded(lp["moe"], cfg, h, par, mode))
        return x + m, aux["lb_loss"]
    return x + _sum(par, L.mlp(lp["mlp"], cfg, h)), None


# ===========================================================================
# forward (teacher forcing)
# ===========================================================================
def _decoder_block(lp, cfg: ModelConfig, x, positions, window: int = 0,
                   memory=None, kv=None, par=None):
    """One block: (x, its MoE load-balance loss or None). With
    ``memory`` (an ENCDEC decoder layer), the ungated cross-attention of
    ``rmsnorm(x, lnx)`` over it follows (``kv``: the memory's K/V, already
    projected). Under ``par`` (a dense layer, ``cfg`` the rank's local
    config) attention runs on the rank's heads and ``wo``'s partial
    product is summed over the ranks."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        x = x + MLA.mla_attention(lp["attn"], cfg, h, positions, window)[0]
    else:
        x = x + _sum(par, L.attention(lp["attn"], cfg, h, positions,
                                      window=window))
    x, lb = _ffn_residual(lp, cfg, x, par)
    if memory is not None:
        h = L.rmsnorm(x, lp["lnx"], cfg.norm_eps)
        x = x + L.cross_attention(lp["xattn"], cfg, h, memory, kv)
    return x, lb


def _run_decoder_stack(stacked, cfg: ModelConfig, x, positions,
                       remat: bool = False, window: int = 0, memory=None,
                       par=None):
    """The decoder blocks in turn (with ``memory``, each followed by its
    cross-attention over it); ``remat`` checkpoints each one (its
    activations are recomputed in the backward pass). The forward draws
    no random numbers, so no RNG state is stashed. Returns (x, the
    load-balance losses summed over layers, a 0-d f32: zero for a dense
    stack), summed in layer order from zero as the JAX scan sums them."""
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unstack(stacked):
        x, lb_i = _maybe_remat(remat, _decoder_block, lp, cfg, x, positions,
                               window, memory, None, par)
        if lb_i is not None:
            lb = lb + lb_i
    return x, lb


def _seq_inputs(params, tokens, par=None):
    """Embeddings and (B, S) positions 0..S-1 of a full sequence."""
    b, s = tokens.shape
    x = L.embed_lookup(params["embed"], tokens, par)
    return x, torch.arange(s, device=x.device).expand(b, s)


def forward(params: Params, cfg: ModelConfig, batch: Dict, remat=False,
            window: Optional[int] = None, parallel=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forcing full-sequence pass. batch: {"tokens": (B, S) int},
    and for VLM and ENCDEC "frontend" (B, F, D) in the model dtype.
    Returns (logits (B, S, V), aux): aux is the MoE load-balancing loss
    summed over layers, a 0-d f32 (zero for the dense decoder, VLM and
    the recurrent families). ``remat`` (for training under autograd):
    "layer" checkpoints each decoder block (a VLM's cross blocks too; an
    ENCDEC model's encoder layers, and its decoder layers with their
    cross-attention; a recurrent model: each Mamba2 layer and group, each
    xLSTM pattern group), True /
    "full" the whole pass, False / None nothing (the JAX package's
    ``LAYER_REMAT`` and ``jax.checkpoint`` of ``forward``). ``window``:
    sliding-window attention over that many positions
    (``cfg.attention_window`` when None; 0 is full attention).
    ``parallel``: a ``ParallelContext`` (a dense decoder, ``params`` the
    rank's shard): the rank's heads and features, the row-parallel sums,
    the vocab-parallel embedding and head; every rank gets the whole
    logits."""
    check_supported(cfg, parallel=parallel)
    if remat and remat != "layer":
        return checkpoint(forward, params, cfg, batch, False, window,
                          parallel, use_reentrant=False,
                          preserve_rng_state=False)
    par = _par(parallel)
    cfg = _local(cfg, par)
    x, positions = _seq_inputs(params, batch["tokens"], par)
    w, layer = _window(cfg, window), remat == "layer"
    if cfg.family == HYBRID:
        x = _hybrid_forward(params, cfg, x, positions, w, layer)
    elif cfg.family == SSM:
        x = _ssm_forward(params, cfg, x, layer)
    elif cfg.family == VLM:
        x = _vlm_forward(params, cfg, x, positions, batch["frontend"], w,
                         layer)
    elif cfg.family == ENCDEC:
        enc = _encode(params, cfg, batch["frontend"], layer)
        x, lb = _run_decoder_stack(params["layers"], cfg, x, positions,
                                   remat=layer, window=w, memory=enc)
        return _head(params, cfg, x), lb
    else:
        x, lb = _run_decoder_stack(params["layers"], cfg, x, positions,
                                   remat=layer, window=w, par=par)
        if par is not None and cfg.moe is not None:
            # each rank's losses summed over layers, then the reference's
            # per-layer pmean over every rank once (the mean is linear)
            lb = par.mean_all(lb)
        return _head(params, cfg, x, par), lb
    return _head(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


# -- VLM ----------------------------------------------------------------------
def _cross_block(cp, cfg: ModelConfig, x, memory, kv=None):
    """A gated cross layer: tanh(gate) x cross-attention over ``memory``
    (``kv``: its K/V, already projected), then tanh(gate_mlp) x its MLP,
    each on its normed residual."""
    h = L.rmsnorm(x, cp["ln"], cfg.norm_eps)
    return _gated_residuals(cp, cfg, x, L.cross_attention(
        cp["xattn"], cfg, h, memory, kv))


def _gated_residuals(cp, cfg: ModelConfig, x, a):
    """x plus tanh(gate) x the cross-attention output ``a``, then plus
    tanh(gate_mlp) x the MLP of that residual, normed."""
    x = x + torch.tanh(cp["gate"]) * a
    h = L.rmsnorm(x, cp["ln_mlp"], cfg.norm_eps)
    return x + torch.tanh(cp["gate_mlp"]) * L.mlp(cp["mlp"], cfg, h)


def _vlm_forward(params, cfg: ModelConfig, x, positions, memory, window: int,
                 remat: bool = False):
    """Each group's decoder blocks, then its cross layer over the
    frontend; ``remat`` checkpoints each block and each cross layer."""
    for lps, cp in zip(_unstack(params["layers"]), _unstack(params["cross"])):
        x = _run_decoder_stack(lps, cfg, x, positions, remat, window)[0]
        x = _maybe_remat(remat, _cross_block, cp, cfg, x, memory)
    return x


# -- ENCDEC -------------------------------------------------------------------
def _encoder_layer(lp, cfg: ModelConfig, x, positions):
    """Bidirectional self-attention over the frames (RoPE on the frame
    positions, no mask), then the MLP, each on its normed residual."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L._qkv(lp["attn"], cfg, h, h)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    x = x + L._sdpa(q, k, v, None, cfg.q_per_kv) @ lp["attn"]["wo"]
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp(lp["mlp"], cfg, h)


def _encode(params, cfg: ModelConfig, frontend, remat: bool = False):
    """The encoder over the frames (B, F, D): each layer in turn
    (``remat`` checkpoints each), then ``enc_ln``."""
    b, f_len, _ = frontend.shape
    positions = torch.arange(f_len, device=frontend.device).expand(b, f_len)
    x = frontend
    for lp in _unstack(params["encoder"]):
        x = _maybe_remat(remat, _encoder_layer, lp, cfg, x, positions)
    return L.rmsnorm(x, params["enc_ln"], cfg.norm_eps)


# -- the recurrent families ---------------------------------------------------
def _maybe_remat(remat: bool, fn, *args):
    """fn(*args), checkpointed when ``remat`` (the bodies the reference's
    ``_scan`` checkpoints under ``LAYER_REMAT``)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _hybrid_split(stacked, cfg: ModelConfig):
    """Per-layer views of a HYBRID stack (``params["layers"]`` or
    ``cache["ssm"]``) in either layout: (n_groups lists of
    ``shared_attn_every`` layers, the tail: the flat layout's remaining
    layers, run after the last group)."""
    every = cfg.ssm.shared_attn_every
    n_groups, rem = divmod(cfg.num_layers, every)
    if rem == 0:
        return [_unstack(g) for g in _unstack(stacked)], []
    flat = _unstack(stacked)
    return ([flat[g * every:(g + 1) * every] for g in range(n_groups)],
            flat[n_groups * every:])


def _store_state(old, new, active=None) -> None:
    """Write a recurrent state into the cache's own views ``old`` (a
    dict or tuple of tensors, as ``new``) in place; rows with ``active``
    False keep their old bits (the reference's ``_mask_state``)."""
    for o, n in zip(tree.leaves(old), tree.leaves(new)):
        if active is not None:
            n = torch.where(active.view(-1, *(1,) * (n.dim() - 1)), n, o)
        o.copy_(n)


def _shared_attn_block(sp, cfg: ModelConfig, x, positions, window: int):
    h = L.rmsnorm(x, sp["ln1"], cfg.norm_eps)
    x = x + L.attention(sp["attn"], cfg, h, positions, window=window)
    h = L.rmsnorm(x, sp["ln2"], cfg.norm_eps)
    return x + L.mlp(sp["mlp"], cfg, h)


def _mamba_layer(lp, cfg: ModelConfig, x):
    h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
    return x + S.mamba2_forward(lp["mamba"], cfg, h)[0]


def _hybrid_group(lps, sp, cfg: ModelConfig, x, positions, window: int,
                  remat: bool):
    for lp in lps:
        x = _maybe_remat(remat, _mamba_layer, lp, cfg, x)
    return _shared_attn_block(sp, cfg, x, positions, window)


def _hybrid_forward(params, cfg: ModelConfig, x, positions, window: int,
                    remat: bool = False):
    """Zamba2: each group of Mamba2 layers, then the shared block; the
    flat layout's tail last. ``remat`` checkpoints each group and each
    Mamba2 layer in it."""
    groups, tail = _hybrid_split(params["layers"], cfg)
    for lps in groups:
        x = _maybe_remat(remat, _hybrid_group, lps, params["shared_attn"],
                         cfg, x, positions, window, remat)
    for lp in tail:
        x = _maybe_remat(remat, _mamba_layer, lp, cfg, x)
    return x


def _ssm_group(lps, cfg: ModelConfig, x):
    """One xLSTM pattern group: each block kind's residual in turn."""
    for i, kind in enumerate(_pattern(cfg)):
        lp = lps[f"blk{i}_{kind}"]
        h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
        fwd = S.mlstm_forward if kind == "mlstm" else S.slstm_forward
        x = x + fwd(lp["core"], cfg, h)[0]
    return x


def _ssm_forward(params, cfg: ModelConfig, x, remat: bool = False):
    for lps in _unstack(params["layers"]):
        x = _maybe_remat(remat, _ssm_group, lps, cfg, x)
    return x


# ===========================================================================
# caches
# ===========================================================================
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda", frontend_len: Optional[int] = None,
               parallel=None) -> Params:
    """Dense KV cache for ``batch`` slots of ``cache_len`` tokens (int8
    values with per-token scales when cfg.kv_cache_dtype == "int8"); with
    ``cfg.attention_window`` a ring of min(cache_len, window) entries, as
    in the JAX package. VLM and ENCDEC add the cross memory's K/V in the
    model dtype, zeros, "xk" / "xv" (n_groups, B, F, Hkv, hd) for VLM,
    (num_layers, B, F, Hkv, hd) for ENCDEC, with F = ``frontend_len`` or
    ``cfg.frontend_tokens``; a VLM's self-attention K/V stay flat (module
    docstring). MLA: the latent "c_kv" / "k_r" (module docstring); an
    int8 MLA cache raises NotImplementedError. ``parallel``: this rank's
    cache, Hkv/tp kv heads (``sharding.serving_cache_specs``'s head
    split), a cache of its own (the kernels read contiguous rows)."""
    check_supported(cfg, parallel=parallel)
    cfg = _local(cfg, _par(parallel))
    eff = min(cache_len, cfg.attention_window) if cfg.attention_window \
        else cache_len
    if cfg.family in RECURRENT:
        return _recurrent_cache(cfg, batch, eff, device)
    if cfg.mla is not None:
        if cfg.kv_cache_dtype:
            raise NotImplementedError(
                f"kv_cache_dtype={cfg.kv_cache_dtype!r} with MLA: the port has "
                "no int8 layout for the latent cache (c_kv, k_r: no scales), "
                "and neither has the JAX package, whose MLA cache silently "
                "stays in the model dtype")
        return {"kv": MLA.init_mla_cache(cfg, cfg.num_layers, batch, eff,
                                         device=device)}
    cache = {"kv": L.init_kv_cache(cfg, cfg.num_layers, batch, eff,
                                   device=device)}
    if cfg.family in CROSS:
        shape = (_cross_layers(cfg), batch,
                 frontend_len or cfg.frontend_tokens, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        for name in ("xk", "xv"):
            cache[name] = torch.zeros(shape, dtype=L.torch_dtype(cfg.dtype),
                                      device=device)
    return cache


def _cross_layers(cfg: ModelConfig) -> int:
    """Cross-attention layers: a VLM's groups, every ENCDEC decoder
    layer."""
    return (cfg.num_layers // cfg.cross_attn_every if cfg.family == VLM
            else cfg.num_layers)


def _recurrent_cache(cfg: ModelConfig, batch: int, eff: int, device):
    """The recurrent states under "ssm" in the layer layout of the
    params (SSM: (n_groups, B, ...) per block kind; HYBRID: (n_groups,
    every, B, ...) or flat (n, B, ...)); HYBRID adds a dense fp KV entry
    per shared-block application, (n_groups, B, eff, Hkv, hd)."""
    def stacked(state, lead):
        return tree.map(lambda a: a.expand(*lead, *a.shape).clone(), state)
    if cfg.family == SSM:
        n_groups = cfg.num_layers // len(_pattern(cfg))
        return {"ssm": {
            f"blk{i}_{kind}": stacked(
                (S.init_mlstm_state if kind == "mlstm"
                 else S.init_slstm_state)(cfg, batch, device), (n_groups,))
            for i, kind in enumerate(_pattern(cfg))}}
    every = cfg.ssm.shared_attn_every
    n_groups, rem = divmod(cfg.num_layers, every)
    lead = (cfg.num_layers,) if rem else (n_groups, every)
    shape = (n_groups, batch, eff, cfg.num_kv_heads, cfg.resolved_head_dim)
    dtype = L.torch_dtype(cfg.dtype)
    return {"ssm": stacked(S.init_mamba2_state(cfg, batch, device), lead),
            "kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device="cuda", parallel=None) -> Params:
    """Paged KV cache: one pool of ``num_blocks`` physical blocks per
    layer (plus the sink block); slots own blocks via block tables. fp
    and full attention only, as in the JAX package. ``parallel`` as for
    :func:`init_cache`."""
    check_supported(cfg, paged=True, parallel=parallel)
    cfg = _local(cfg, _par(parallel))
    return {"kv": L.init_paged_kv_cache(cfg, cfg.num_layers, num_blocks,
                                        block_size, device=device)}


# ===========================================================================
# decode / prefill
# ===========================================================================
def prefill(params: Params, cfg: ModelConfig, batch: Dict,
            window: Optional[int] = None, parallel=None
            ) -> Tuple[torch.Tensor, Params]:
    """Full-prompt prefill. batch: {"tokens": (B, S) int, optional
    "cache_len" (default S); VLM and ENCDEC: "frontend" (B, F, D)}.
    Returns (last-token logits (B, V), a new dense cache of ``cache_len``
    tokens, or of the config's window when that is shorter, holding the
    prompt's K/V; a cache shorter than S keeps the last entries in ring
    layout; VLM: and the frontend's cross K/V, F rows; ENCDEC: the
    encoder output's, F rows a layer). ``window`` and ``parallel`` as in
    :func:`forward`."""
    check_supported(cfg, parallel=parallel)
    tokens = batch["tokens"]
    memory = batch.get("frontend")
    cache = init_cache(cfg, tokens.shape[0],
                       batch.get("cache_len", tokens.shape[1]),
                       device=params["embed"].device,
                       frontend_len=None if memory is None
                       else memory.shape[1], parallel=parallel)
    par = _par(parallel)
    cfg = _local(cfg, par)
    x = _fill_cache(params, cfg, tokens, cache, _window(cfg, window), memory,
                    par)
    return _head(params, cfg, x[:, -1:], par)[:, 0], cache


def _fill_cache(params, cfg, tokens, cache, window: int = 0, memory=None,
                par=None):
    """Run the stack, storing each layer's K/V into the cache: K/V are
    recomputed from the hidden state entering the block (one extra K/V
    product per layer, as in the JAX package). A cache of ``eff`` >= S
    entries takes them zero-padded; a shorter one (a ring) the last
    ``eff`` rolled by S % eff, so position p sits at p % eff. An int8
    cache quantizes after the padding or the roll (padding tokens get
    values 0 and the floor scale). A VLM stores, after each group, its
    cross layer's K/V of ``memory`` (the frontend) into "xk" / "xv"; an
    ENCDEC model encodes ``memory`` first and stores each decoder layer's
    cross K/V of the encoder output. Returns the final hidden state."""
    x, positions = _seq_inputs(params, tokens, par)
    if cfg.family == HYBRID:
        return _hybrid_fill(params, cfg, x, positions, cache, window)
    if cfg.family == SSM:
        return _ssm_fill(params, cfg, x, cache)
    if cfg.mla is not None:
        return _mla_fill(params, cfg, x, positions, cache, window)
    enc = _encode(params, cfg, memory) if cfg.family == ENCDEC else None
    s_len, eff = tokens.shape[1], _kv_len(cache)
    every = cfg.cross_attn_every if cfg.family == VLM else 0
    cross = _unstack(params["cross"]) if every else []
    for i, (lp, kv) in enumerate(zip(_layer_list(params, cfg),
                                     _unstack(cache["kv"]))):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        k, v = L._kv(lp["attn"], cfg, h)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        for name, t in (("k", k), ("v", v)):
            if eff < s_len:
                t = torch.roll(t[:, -eff:], s_len % eff, dims=1)
            else:
                t = F.pad(t, (0, 0, 0, 0, 0, eff - s_len))
            if "k_scale" in kv:
                t, scale = L.quantize_kv(t)
                kv[name + "_scale"].copy_(scale)
            kv[name].copy_(t)           # the cache's own layer view
        xkv = None
        if enc is not None:
            xkv = L._kv(lp["xattn"], cfg, enc)
            cache["xk"][i].copy_(xkv[0])
            cache["xv"][i].copy_(xkv[1])
        x = _decoder_block(lp, cfg, x, positions, window, enc, xkv, par)[0]
        if every and (i + 1) % every == 0:
            g = i // every
            xk, xv = L._kv(cross[g]["xattn"], cfg, memory)
            cache["xk"][g].copy_(xk)
            cache["xv"][g].copy_(xv)
            x = _cross_block(cross[g], cfg, x, memory, (xk, xv))
    return x


def _mla_fill(params, cfg: ModelConfig, x, positions, cache, window):
    """MLA's prefill: each layer's latent and rope key, as its attention
    computes them, zero-padded to the cache length. A cache shorter than
    the prompt raises ValueError (the reference's ``jnp.pad`` refuses the
    negative width; no ring layout is written)."""
    s_len, eff = x.shape[1], _kv_len(cache)
    if eff < s_len:
        raise ValueError(f"an MLA cache of {eff} entries cannot take a "
                         f"prompt of {s_len} tokens")
    for lp, kv in zip(_unstack(params["layers"]), _unstack(cache["kv"])):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, c_kv, k_r = MLA.mla_attention(lp["attn"], cfg, h, positions,
                                         window)
        kv["c_kv"].copy_(F.pad(c_kv, (0, 0, 0, eff - s_len)))
        kv["k_r"].copy_(F.pad(k_r, (0, 0, 0, eff - s_len)))
        x = _ffn_residual(lp, cfg, x + a)[0]
    return x


def _hybrid_fill(params, cfg: ModelConfig, x, positions, cache, window):
    """Zamba2's prefill: each Mamba2 layer's final state and its conv
    state (the last three pre-activation ``xbc`` rows of the layer's one
    input projection), each shared-block application's K/V zero-padded
    to the cache length."""
    sp = params["shared_attn"]
    s_len, eff = x.shape[1], _kv_len(cache)
    if eff < s_len:
        raise ValueError(f"a hybrid cache of {eff} entries cannot take a "
                         f"prompt of {s_len} tokens")

    def mamba(lp, st, x):
        h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
        proj = S._split_proj(lp["mamba"], cfg, h)
        y, h_final = S.mamba2_scan(lp["mamba"], cfg, *proj)
        _store_state(st, {"h": h_final, "conv": proj[1][:, -3:]})
        return x + y
    groups, tail = _hybrid_split(params["layers"], cfg)
    states, st_tail = _hybrid_split(cache["ssm"], cfg)
    for g, (lps, sts) in enumerate(zip(groups, states)):
        for lp, st in zip(lps, sts):
            x = mamba(lp, st, x)
        h = L.rmsnorm(x, sp["ln1"], cfg.norm_eps)
        k, v = L._kv(sp["attn"], cfg, h)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        for name, t in (("k", k), ("v", v)):
            cache["kv"][name][g].copy_(F.pad(t, (0, 0, 0, 0, 0,
                                                 eff - s_len)))
        x = _shared_attn_block(sp, cfg, x, positions, window)
    for lp, st in zip(tail, st_tail):
        x = mamba(lp, st, x)
    return x


def _ssm_fill(params, cfg: ModelConfig, x, cache):
    """xLSTM's prefill: each block's final state."""
    for lps, sts in zip(_unstack(params["layers"]), _unstack(cache["ssm"])):
        for i, kind in enumerate(_pattern(cfg)):
            key = f"blk{i}_{kind}"
            h = L.rmsnorm(x, lps[key]["ln"], cfg.norm_eps)
            fwd = S.mlstm_forward if kind == "mlstm" else S.slstm_forward
            y, st = fwd(lps[key]["core"], cfg, h)
            _store_state(sts[key], st)
            x = x + y
    return x


def _hybrid_decode(params, cfg: ModelConfig, x, cache, pos, decode_impl,
                   active, window: int):
    """Zamba2's decode step: the Mamba2 layers' O(1) updates (inactive
    rows keep their state bits), and each shared-block application's
    attention over its own KV entry. Unlike the reference, which always
    takes its XLA path here, ``decode_impl`` reaches the shared block:
    on the card it runs the decode kernel."""
    sp = params["shared_attn"]
    kvs = [{"k": k, "v": v} for k, v in zip(cache["kv"]["k"].unbind(0),
                                            cache["kv"]["v"].unbind(0))]
    # a model shallower than one group has no shared block, so no KV
    idx = L.decode_index(cfg, pos, kvs[0], active, window) if kvs else None

    def mamba(lp, st, x):
        h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
        y, new = S.mamba2_decode(lp["mamba"], cfg, h, st)
        _store_state(st, new, active)
        return x + y
    groups, tail = _hybrid_split(params["layers"], cfg)
    states, st_tail = _hybrid_split(cache["ssm"], cfg)
    for lps, sts, kv in zip(groups, states, kvs):
        for lp, st in zip(lps, sts):
            x = mamba(lp, st, x)
        h = L.rmsnorm(x, sp["ln1"], cfg.norm_eps)
        a, _ = L.decode_attention(sp["attn"], cfg, h, kv, idx.pos,
                                  decode_impl=decode_impl, active=active,
                                  idx=idx)
        x = x + a
        x = x + L.mlp(sp["mlp"], cfg, L.rmsnorm(x, sp["ln2"], cfg.norm_eps))
    for lp, st in zip(tail, st_tail):
        x = mamba(lp, st, x)
    return x


def _ssm_decode(params, cfg: ModelConfig, x, cache, active):
    """xLSTM's decode step; inactive rows keep their state bits."""
    for lps, sts in zip(_unstack(params["layers"]), _unstack(cache["ssm"])):
        for i, kind in enumerate(_pattern(cfg)):
            key = f"blk{i}_{kind}"
            h = L.rmsnorm(x, lps[key]["ln"], cfg.norm_eps)
            step = S.mlstm_decode if kind == "mlstm" else S.slstm_decode
            y, new = step(lps[key]["core"], cfg, h, sts[key])
            _store_state(sts[key], new, active)
            x = x + y
    return x


def decode_step(params: Params, cfg: ModelConfig, token, cache: Params, pos,
                decode_impl: str = "kernel", active=None,
                window: Optional[int] = None, parallel=None
                ) -> Tuple[torch.Tensor, Params]:
    """token: (B,1) int; pos: scalar or (B,) per-row positions; active:
    optional (B,) bool — rows with active=False leave the cache
    bit-identical and get garbage logits. The cache may be fp or int8
    (init_cache, prefill), and with a window (``window``, or the
    config's when None) a ring. One :class:`layers.DecodeIndex` serves
    every layer. A recurrent model updates its states (inactive rows
    keep theirs bit for bit) and, for HYBRID, the shared block's KV. A
    VLM's cross layers and an ENCDEC model's decoder layers attend the
    cached memory ("xk" / "xv"), which a step never writes. An MLA model
    runs ``mla.mla_decode`` on its latent cache and ignores
    ``decode_impl``, as the reference does. ``parallel`` as in
    :func:`forward` (the cache is the rank's, :func:`init_cache`): the
    decode kernel runs on the rank's heads. Returns (logits (B,V),
    cache)."""
    check_supported(cfg, parallel=parallel)
    par = _par(parallel)
    cfg = _local(cfg, par)
    x = L.embed_lookup(params["embed"], token, par)
    if cfg.family == HYBRID:
        x = _hybrid_decode(params, cfg, x, cache, pos, decode_impl, active,
                           _window(cfg, window))
        return _head(params, cfg, x)[:, 0], cache
    if cfg.family == SSM:
        x = _ssm_decode(params, cfg, x, cache, active)
        return _head(params, cfg, x)[:, 0], cache
    layer_kv = _unstack(cache["kv"])
    idx = L.decode_index(cfg, pos, layer_kv[0], active, _window(cfg, window))
    every = cfg.cross_attn_every if cfg.family == VLM else 0
    cross = _unstack(params["cross"]) if every else []
    for i, (lp, kv) in enumerate(zip(_layer_list(params, cfg), layer_kv)):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if cfg.mla is not None:
            a = MLA.mla_decode(lp["attn"], cfg, h, kv, idx)
        else:
            a, _ = L.decode_attention(lp["attn"], cfg, h, kv, idx.pos,
                                      decode_impl=decode_impl, active=active,
                                      idx=idx)
            a = _sum(par, a)
        x = _ffn_residual(lp, cfg, x + a, par, "psum")[0]
        if cfg.family == ENCDEC:
            h = L.rmsnorm(x, lp["lnx"], cfg.norm_eps)
            x = x + _cross_decode_attention(lp["xattn"], cfg, h,
                                            cache["xk"][i], cache["xv"][i])
        elif every and (i + 1) % every == 0:
            g = i // every
            x = _cross_decode(cross[g], cfg, x, cache["xk"][g],
                              cache["xv"][g])
    return _head(params, cfg, x, par)[:, 0], cache


def _cross_decode_attention(p, cfg: ModelConfig, h, xk, xv):
    """Cross-attention at decode: the new token's query (no ``bq``, as in
    the reference's decode) against the cached memory K/V, (B, F, Hkv,
    hd), through ``_sdpa``."""
    q = (h @ p["wq"]).reshape(h.shape[0], 1, cfg.num_heads, -1)
    return L._sdpa(q, xk, xv, None, cfg.q_per_kv) @ p["wo"]


def _cross_decode(cp, cfg: ModelConfig, x, xk, xv):
    """A VLM cross layer at decode: :func:`_cross_decode_attention` of
    the normed residual; the gates and the MLP as
    :func:`_cross_block`."""
    h = L.rmsnorm(x, cp["ln"], cfg.norm_eps)
    return _gated_residuals(cp, cfg, x, _cross_decode_attention(
        cp["xattn"], cfg, h, xk, xv))


def paged_decode_step(params: Params, cfg: ModelConfig, token,
                      cache: Params, block_tables, pos,
                      decode_impl: str = "kernel", active=None,
                      parallel=None) -> Tuple[torch.Tensor, Params]:
    """Paged analog of :func:`decode_step`; block_tables: (B, NB) int."""
    check_supported(cfg, paged=True, parallel=parallel)
    par = _par(parallel)
    cfg = _local(cfg, par)
    x = L.embed_lookup(params["embed"], token, par)
    ks, vs = cache["kv"]["k"].unbind(0), cache["kv"]["v"].unbind(0)
    idx = L.paged_decode_index(cfg, pos, {"k": ks[0]}, block_tables, active)
    for lp, k, v in zip(_unstack(params["layers"]), ks, vs):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = L.paged_decode_attention(lp["attn"], cfg, h, {"k": k, "v": v},
                                        block_tables, idx.pos,
                                        decode_impl=decode_impl,
                                        active=active, idx=idx)
        x = _ffn_residual(lp, cfg, x + _sum(par, a), par, "psum")[0]
    return _head(params, cfg, x, par)[:, 0], cache


def _chunk_attention(lp, cfg, x, rope, valid, kv_view, par=None):
    """Attention half of one fused prefill layer. ``rope``: the chunk
    positions' (cos, sin); ``valid``: (B, L, T) keys each query sees
    (cache entries j <= its position); ``kv_view(k, v)`` writes the
    chunk's K/V and returns the (B, T, Hkv, hd) keys/values the queries
    attend (cache prefix + this chunk)."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L._qkv(lp["attn"], cfg, h, h)
    q, k = L._rotate(q, *rope), L._rotate(k, *rope)
    k_all, v_all = kv_view(k, v)
    a = L._sdpa(q, k_all, v_all, valid, cfg.q_per_kv)
    return x + _sum(par, a @ lp["attn"]["wo"])


def _last_logits(params, cfg, x, lengths, par=None):
    """LM head over each row's last valid chunk position only."""
    b, l, d = x.shape
    last = torch.clamp(lengths - 1, 0, l - 1)
    x = x.gather(1, last[:, None, None].expand(b, 1, d))
    return _head(params, cfg, x, par)[:, 0]


def _chunk_inputs(params, cfg, tokens, start_pos, lengths, t_max: int,
                  par=None):
    """Per-chunk quantities every layer shares: embeddings, rope tables
    of the chunk positions, and the (B, L, T) causal validity."""
    b, l = tokens.shape
    start_pos = torch.as_tensor(start_pos, device=tokens.device).long()
    lengths = torch.as_tensor(lengths, device=tokens.device).long()
    x = L.embed_lookup(params["embed"], tokens, par)
    positions = start_pos[:, None] + torch.arange(l, device=x.device)[None]
    rope = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    valid = torch.arange(t_max, device=x.device)[None, None, :] \
        <= positions[:, :, None]
    return x, start_pos, lengths, rope, valid


def prefill_chunk(params: Params, cfg: ModelConfig, tokens, cache: Params,
                  start_pos, lengths, decode_impl: str = "kernel",
                  window: Optional[int] = None, parallel=None
                  ) -> Tuple[torch.Tensor, Params]:
    """Batched multi-slot chunked prefill: one call advances every row by
    up to L tokens. tokens: (B, L) zero-padded chunks; start_pos: (B,);
    lengths: (B,) valid tokens (0 => bitwise no-op row). Returns
    (logits after each row's last valid token (B, V), cache). Full
    attention runs the fused sequence-level chunk (``decode_impl`` is
    unused there); a window (``window``, or the config's when None), VLM,
    MLA and the recurrent families the masked per-token decode loop, as
    in the JAX package. ENCDEC is refused (:func:`_engine_step`).
    ``parallel`` as in :func:`decode_step`."""
    _engine_step(cfg, "prefill_chunk", parallel)
    if _per_token(cfg, window):
        return _per_token_chunk(params, cfg, tokens, cache, start_pos,
                                lengths, decode_impl, window,
                                parallel=parallel)
    par = _par(parallel)
    return _prefill_chunk_fused(params, _local(cfg, par), tokens, cache,
                                start_pos, lengths, par=par)


def _per_token_chunk(params, cfg, tokens, cache, start_pos, lengths,
                     decode_impl, window, all_logits: bool = False,
                     parallel=None):
    """The masked per-token fallback of :func:`prefill_chunk` and
    :func:`verify_step`: token column t goes through :func:`decode_step`
    at ``start_pos + t`` with ``active = t < lengths``, on the
    parameters' device and through ``decode_impl``. Returns each row's logits where
    it was last active, zeros for an idle row (``all_logits``: every
    step's, (B, L, V)), and the cache; a ``lengths == 0`` row is a
    bitwise no-op."""
    b, l = tokens.shape
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    start_pos = torch.as_tensor(start_pos, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev).long()
    dtype = L.torch_dtype(cfg.dtype)
    out = torch.zeros((b, l, cfg.vocab_size) if all_logits
                      else (b, cfg.vocab_size), dtype=dtype, device=dev)
    for t in range(l):
        act = t < lengths
        lg, cache = decode_step(params, cfg, tokens[:, t:t + 1], cache,
                                start_pos + t, decode_impl=decode_impl,
                                active=act, window=window,
                                parallel=parallel)
        if all_logits:
            out[:, t] = lg
        else:
            out = torch.where(act[:, None], lg.to(dtype), out)
    return out, cache


def _prefill_chunk_fused(params, cfg, tokens, cache, start_pos, lengths,
                         all_logits: bool = False, par=None):
    """Write the chunk's K/V into the cache in place, then attend the
    chunk's queries over (cache prefix + chunk) causally; an int8 cache
    takes the chunk quantized and is attended dequantized, as in the JAX
    package. ``all_logits`` (the speculative verify path) returns the LM
    head over every chunk position, (B, L, V), instead of each row's
    last."""
    layer_kv = _unstack(cache["kv"])
    x, start_pos, lengths, rope, valid = _chunk_inputs(
        params, cfg, tokens, start_pos, lengths, layer_kv[0]["k"].shape[1],
        par)
    index = L.chunk_write_index(start_pos, lengths, tokens.shape[1],
                                layer_kv[0])
    for lp, kv in zip(_unstack(params["layers"]), layer_kv):
        def kv_view(k, v, kv=kv):
            L.write_chunk_kv(kv, k, v, start_pos, lengths, index=index)
            if "k_scale" in kv:
                return (L.dequantize_kv(kv["k"], kv["k_scale"]),
                        L.dequantize_kv(kv["v"], kv["v_scale"]))
            return kv["k"], kv["v"]
        x = _ffn_residual(lp, cfg, _chunk_attention(lp, cfg, x, rope, valid,
                                                    kv_view, par), par)[0]
    return _chunk_logits(params, cfg, x, lengths, all_logits, par), cache


def _chunk_logits(params, cfg, x, lengths, all_logits: bool, par=None):
    return _head(params, cfg, x, par) if all_logits \
        else _last_logits(params, cfg, x, lengths, par)


def paged_prefill_chunk(params: Params, cfg: ModelConfig, tokens,
                        cache: Params, block_tables, start_pos, lengths,
                        all_logits: bool = False, parallel=None
                        ) -> Tuple[torch.Tensor, Params]:
    """Paged analog of :func:`prefill_chunk`: the chunk's K/V go through
    the block table, and the queries attend the gathered pages."""
    check_supported(cfg, paged=True, parallel=parallel)
    par = _par(parallel)
    cfg = _local(cfg, par)
    ks, vs = cache["kv"]["k"].unbind(0), cache["kv"]["v"].unbind(0)
    p_blocks, bs = ks[0].shape[0] - 1, ks[0].shape[1]
    x, start_pos, lengths, rope, valid = _chunk_inputs(
        params, cfg, tokens, start_pos, lengths,
        block_tables.shape[1] * bs, par)
    flat = L.paged_chunk_index(block_tables, start_pos, lengths,
                               tokens.shape[1], {"k": ks[0]})
    for lp, kc, vc in zip(_unstack(params["layers"]), ks, vs):
        def kv_view(k, v, kc=kc, vc=vc):
            L.write_chunk_kv_paged({"k": kc, "v": vc}, k, v, block_tables,
                                   start_pos, lengths, flat=flat)
            return (L.gather_pages(kc[:p_blocks], block_tables),
                    L.gather_pages(vc[:p_blocks], block_tables))
        x = _ffn_residual(lp, cfg, _chunk_attention(lp, cfg, x, rope, valid,
                                                    kv_view, par), par)[0]
    return _chunk_logits(params, cfg, x, lengths, all_logits, par), cache


def verify_step(params: Params, cfg: ModelConfig, tokens, cache: Params,
                start_pos, lengths, decode_impl: str = "kernel",
                window: Optional[int] = None, parallel=None
                ) -> Tuple[torch.Tensor, Params]:
    """Speculative multi-token verify: advance every row by its
    [last_tok, draft_1..draft_w] window in one call and return the logits
    at EVERY window position, so the caller can accept the longest draft
    prefix matching the model's own greedy argmax. It is
    :func:`prefill_chunk`'s pass (the fused chunk, or with a window, VLM,
    MLA or a recurrent model the per-token loop) with the LM head over all L
    positions; ``lengths == 0`` rows stay bitwise no-ops, and a rejected
    position's K/V is overwritten by the next write there (not so on a
    ring: the engine refuses speculation with a window; a recurrent
    state is advanced by every position below ``lengths``). tokens: (B, L);
    start_pos/lengths: (B,). Returns (logits (B, L, V), cache); positions
    past ``lengths`` and idle rows hold garbage the caller masks. ENCDEC
    is refused (:func:`_engine_step`)."""
    _engine_step(cfg, "verify_step", parallel)
    if _per_token(cfg, window):
        return _per_token_chunk(params, cfg, tokens, cache, start_pos,
                                lengths, decode_impl, window,
                                all_logits=True, parallel=parallel)
    par = _par(parallel)
    return _prefill_chunk_fused(params, _local(cfg, par), tokens, cache,
                                start_pos, lengths, all_logits=True, par=par)


def paged_verify_step(params: Params, cfg: ModelConfig, tokens,
                      cache: Params, block_tables, start_pos, lengths,
                      parallel=None) -> Tuple[torch.Tensor, Params]:
    """Paged analog of :func:`verify_step`: the
    :func:`paged_prefill_chunk` pass with the LM head over all window
    positions. Returns (logits (B, L, V), cache)."""
    return paged_prefill_chunk(params, cfg, tokens, cache, block_tables,
                               start_pos, lengths, all_logits=True,
                               parallel=parallel)


def mixed_step(params: Params, cfg: ModelConfig, tokens, cache: Params, pos,
               lengths, decode_tokens, decode_active,
               decode_impl: str = "kernel", window: Optional[int] = None,
               parallel=None) -> Tuple[torch.Tensor, Params]:
    """Fused prefill + decode: advance every prefill row (lengths > 0) by
    one chunk and every decode row (decode_active) by one token in one
    call. The row sets are disjoint and each half is exactly the
    separate call, so the tokens equal the sequential path's. Returns
    (decode logits (B, V), cache). ENCDEC is refused
    (:func:`_engine_step`)."""
    _engine_step(cfg, "mixed_step", parallel)
    _, cache = prefill_chunk(params, cfg, tokens, cache, pos, lengths,
                             decode_impl=decode_impl, window=window,
                             parallel=parallel)
    return decode_step(params, cfg, decode_tokens, cache, pos,
                       decode_impl=decode_impl, active=decode_active,
                       window=window, parallel=parallel)


def paged_mixed_step(params: Params, cfg: ModelConfig, tokens,
                     cache: Params, block_tables, pos, lengths,
                     decode_tokens, decode_active,
                     decode_impl: str = "kernel", parallel=None
                     ) -> Tuple[torch.Tensor, Params]:
    """Paged analog of :func:`mixed_step`."""
    _, cache = paged_prefill_chunk(params, cfg, tokens, cache, block_tables,
                                   pos, lengths, parallel=parallel)
    return paged_decode_step(params, cfg, decode_tokens, cache,
                             block_tables, pos, decode_impl=decode_impl,
                             active=decode_active, parallel=parallel)
