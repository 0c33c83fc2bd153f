"""Control readings for chip_smoke.py phase 17 (c)'s bf16 truth gate, on
a CUDA card: deepseek-v2-236b at its published widths, the first 2 of
phase 17's 6 layers (bf16, seed 0, capacity_factor 4.0), 2 x 512 + 16
through the batch launcher; then each path below prefilled and fed that
run's tokens, every path on that run's routing (``_route_log(replay=)``:
bf16 paths route some tokens to other experts at near-ties, and a token
routed otherwise leaves any drift bound). Each path's largest distance
from the f32 truth (a teacher-forced ``forward`` of the weights upcast
over the same history, on the same routing) is printed in bf16 ulps of
the truth's top logit, beside its ratio to the bf16 forward's.

Sound paths: the absorbed decode (``mla.mla_decode``, the reference's
order of products: the query through ``wuk``, scores against the
latent, ``wuv`` after); the same with cuBLAS's reduced-precision bf16
reductions off (``allow_bf16_reduced_precision_reduction``); the same
with its intermediates (the latent query, the scores, the latent
context) kept in f32; the expanded decode (each cached row's K and V
through ``wuk`` / ``wuv``, rounded to bf16, as the forward computes
them). Planted, each only while its path runs: the latent cache rounded
through fp8 e4m3 (a lower precision); the new token's rope key written
without its rotation (a wrong path); the latent written without
``kv_norm`` (a wrong path).

    python3 tests/mla_truth_controls.py

Needs one H100-class card with 80 GB (the 6-layer bf16 init is 50.7 GB;
the f32 copy of 2 layers 36.6 GB is made after the other 4 are freed).
"""
import contextlib
import gc
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as C  # noqa: E402


@contextlib.contextmanager
def _patched(obj, name, value):
    orig = getattr(obj, name)
    setattr(obj, name, value(orig) if callable(value) else value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _f32_intermediates():
    """mla_decode with the latent query, the scores and the latent
    context in f32 (weights and cache stay bf16)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import mla

    def decode(p, cfg, x, kv, idx):
        m, b, h = cfg.mla, x.shape[0], cfg.num_heads
        q_nope, q_rope, c_kv, k_r = mla._project(p, cfg, x, idx.cos, idx.sin)
        L._scatter_slot(kv["c_kv"], c_kv[:, 0], idx)
        L._scatter_slot(kv["k_r"], k_r[:, 0], idx)
        ckv, kr = kv["c_kv"].float(), kv["k_r"].float()
        wuk = p["wuk"].float().reshape(m.kv_lora_rank, h, m.nope_head_dim)
        q_lat = torch.einsum("bshd,lhd->bshl", q_nope.float(), wuk)
        scores = (torch.einsum("bshl,btl->bhst", q_lat, ckv)
                  + torch.einsum("bshd,btd->bhst", q_rope.float(), kr)) \
            * mla._scale(cfg)
        scores = torch.where(idx.valid[:, None, None], scores, L.NEG_INF)
        w = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhst,btl->bshl", w, ckv)
        wuv = p["wuv"].float().reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = torch.einsum("bshl,lhd->bshd", ctx, wuv).reshape(b, 1, -1)
        return out.to(x.dtype) @ p["wo"]
    return _patched(mla, "mla_decode", lambda _: decode)


def _expanded():
    """Decode through the expanded form: every cached row's K (nope half
    through ``wuk``, the shared rope key appended) and V (through
    ``wuv``) in bf16, then the forward's score order."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import mla

    def decode(p, cfg, x, kv, idx):
        m, b, h = cfg.mla, x.shape[0], cfg.num_heads
        q_nope, q_rope, c_kv, k_r = mla._project(p, cfg, x, idx.cos, idx.sin)
        L._scatter_slot(kv["c_kv"], c_kv[:, 0], idx)
        L._scatter_slot(kv["k_r"], k_r[:, 0], idx)
        s = kv["c_kv"].shape[1]
        k_nope = (kv["c_kv"] @ p["wuk"]).reshape(b, s, h, m.nope_head_dim)
        v = (kv["c_kv"] @ p["wuv"]).reshape(b, s, h, m.v_head_dim)
        scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
                  + torch.einsum("bshd,btd->bhst", q_rope, kv["k_r"])) \
            * mla._scale(cfg)
        scores = torch.where(idx.valid[:, None, None], scores.float(),
                             L.NEG_INF)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhst,bthd->bshd", w, v).reshape(b, 1, -1)
        return out @ p["wo"]
    return _patched(mla, "mla_decode", lambda _: decode)


def _fp8_latent():
    import torch
    from repro_torch.models import mla

    def wrap(decode):
        def fp8(p, cfg, x, kv, idx):
            for t in kv.values():
                t.copy_(t.to(torch.float8_e4m3fn).to(t.dtype))
            return decode(p, cfg, x, kv, idx)
        return fp8
    return _patched(mla, "mla_decode", wrap)


def _no_rope_key():
    from repro_torch.models import mla

    def wrap(project):
        def project_(p, cfg, x, cos, sin):
            q_nope, q_rope, c_kv, _ = project(p, cfg, x, cos, sin)
            return q_nope, q_rope, c_kv, (x @ p["wkr"])
        return project_
    return _patched(mla, "_project", wrap)


def _no_kv_norm():
    from repro_torch.models import mla

    def wrap(project):
        def project_(p, cfg, x, cos, sin):
            q_nope, q_rope, _, k_r = project(p, cfg, x, cos, sin)
            return q_nope, q_rope, x @ p["wdkv"], k_r
        return project_
    return _patched(mla, "_project", wrap)


def _moe_f32():
    """Every MoE block in f32: its input and weights upcast for the call,
    its output cast back (the rest of the path stays bf16)."""
    from repro_torch.models import moe
    from repro_torch.training import tree

    def wrap(block):
        def f32(p, cfg, x):
            y, aux = block(tree.map(lambda t: t.float(), p), cfg, x.float())
            return y.to(x.dtype), aux
        return f32
    return _patched(moe, "moe_block", wrap)


def _no_reduced_reduction():
    import torch
    return _patched(torch.backends.cuda.matmul,
                    "allow_bf16_reduced_precision_reduction", False)


PATHS = {"absorbed (mla_decode)": contextlib.nullcontext,
         "absorbed, no reduced-precision bf16 reductions":
             _no_reduced_reduction,
         "absorbed, f32 intermediates": _f32_intermediates,
         "expanded K / V": _expanded,
         "absorbed, every MoE block in f32": _moe_f32,
         "planted: latent through fp8": _fp8_latent,
         "planted: rope key unrotated": _no_rope_key,
         "planted: latent without kv_norm": _no_kv_norm}


def main():
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import tree
    smi = C.phase_card()
    cfg, _ = C._p17_configs()
    params = M.init_params(cfg, seed=0, device=C.DEVICE)
    p16 = dict(params, layers=tree.map(
        lambda a: a[:C.P17_F32_LAYERS].clone(), params["layers"]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _, nd = C._p17_configs(C.P17_F32_LAYERS)
    _, nd32 = C._p17_configs(C.P17_F32_LAYERS, "float32")
    p32 = tree.map(lambda t: t.float(), p16)
    b, p, n = C.P17_TF32
    route = {}

    def key(row, b, pos):
        return b, pos
    with C._route_log(route, key):
        run, _ = C._serve_batch(C.batch_args(nd.name, C.P17_TF32), p16)
    run.cache = None
    seq = torch.cat([run.prompt, run.tokens[:, :-1]], dim=1)

    drops = []

    def replayed(fn):
        with torch.no_grad(), C._route_log({}, key, replay=route), \
                C._drop_log(drops):
            return fn()
    truth = replayed(lambda: M.forward(p32, nd32, {"tokens": seq})[0][
        :, p - 1:])
    def by_position(x):
        return " ".join(f"{C._ulps(x[:, j], truth[:, j]):.1f}"
                        for j in range(n))
    fwd16 = replayed(lambda: M.forward(p16, nd, {"tokens": seq})[0][
        :, p - 1:])
    fwd = C._ulps(fwd16, truth)
    with _moe_f32():
        fwd_moe = C._ulps(replayed(lambda: M.forward(
            p16, nd, {"tokens": seq})[0][:, p - 1:]), truth)
    print(f"[mla-controls] {nd.name} bf16, {b} x {p} + {n - 1} fed tokens, "
          f"every path on the launcher run's routing; the bf16 teacher-"
          f"forced forward: {fwd:.2f} ulps from the f32 truth (with every "
          f"MoE block in f32: {fwd_moe:.2f}); by position: "
          f"{by_position(fwd16)} ({smi})")
    for name, ctx in PATHS.items():
        with ctx():
            logits = torch.stack(replayed(lambda: C._p16_fed(
                nd, p16, run.prompt, None, run.tokens)), dim=1)
        d = C._ulps(logits, truth)
        print(f"[mla-controls] {name}: {d:.2f} ulps from the f32 truth, "
              f"{d / fwd:.3f} x the bf16 forward's "
              f"({'over' if d > C.P15_TRUTH_RATIO * fwd else 'within'} "
              f"{C.P15_TRUTH_RATIO}); by position: {by_position(logits)}")
    print(f"[mla-controls] pairs dropped over every replayed call: "
          f"{C._drops(drops)[0]} of {C._drops(drops)[1]}")
    assert math.isfinite(fwd)


if __name__ == "__main__":
    main()
