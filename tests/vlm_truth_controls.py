"""Control readings for chip_smoke.py phase 15's f32-truth gate, on a
CUDA card: phase 15 (a)'s launcher run (llama-3.2-vision-11b at its
published widths and full depth, bf16, seed 0, cross gates 0.5 / -0.7,
4 x 1024 + 16 on the launcher's constant frontend) through sound paths
and through planted faults, each path's largest distance from the f32
teacher-forced truth over its own history (bf16 ulps of the truth's top
logit) printed beside its ratio to the torch path's. The gate
(P15_TRUTH_RATIO) fails a path above that ratio: a sound path should
read under it and a fault over it. Then the same paths on phase 15
(b)'s inputs (2 x 512 + 16, a random frontend): (b)'s bf16 gate, the
decode's distance from the truth over the sound bf16 teacher-forced
forward's (at most P15_TRUTH_RATIO), and (b)'s f32 check, the path run
on the weights upcast against the sound f32 forward (within
P15_FWD_REL of max|logit|).

Sound: the kernel, the torch path, the kernel's plain version (scores,
softmax and P.V in f32). Planted, each only while its path runs: the
self-attention K/V rounded through fp8 e4m3 before the kernel (a path
in a lower precision); the RMSNorm's mean square rounded to bf16 (a
misplaced cast); the cross gates applied without tanh (a wrong path,
prefill and decode); cross-attention dropped at decode (its MLP kept).

    python3 tests/vlm_truth_controls.py

Needs one H100-class card with 80 GB (the truth's f32 copy of the
weights is 46 GB beside the 23 GB bf16 ones); builds the kernels from
the repository's sources first.
"""
import contextlib
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as C  # noqa: E402


@contextlib.contextmanager
def _patched(obj, name, fn):
    orig = getattr(obj, name)
    setattr(obj, name, fn(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _plain_version():
    from repro_torch.kernels import gqa_decode, ops
    return _patched(ops, "gqa_decode", lambda _: (
        lambda q, k, v, valid, active=None:
        gqa_decode.gqa_decode_plain(q, k, v, valid, active)))


def _fp8_kv():
    import torch
    from repro_torch.kernels import ops

    def wrap(kernel):
        def fp8(t):
            return t.to(torch.float8_e4m3fn).to(t.dtype)
        return lambda q, k, v, valid, active=None: kernel(
            q, fp8(k), fp8(v), valid, active)
    return _patched(ops, "gqa_decode", wrap)


def _bf16_mean_square():
    import torch
    from repro_torch.models import layers as L

    def wrap(_):
        def rmsnorm(x, gamma, eps=1e-5):
            var = x.float().square().mean(dim=-1, keepdim=True)
            var = var.to(torch.bfloat16).float()
            return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma
        return rmsnorm
    return _patched(L, "rmsnorm", wrap)


def _gates_without_tanh():
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    def wrap(_):
        def gated(cp, cfg, x, a):
            x = x + cp["gate"] * a
            h = L.rmsnorm(x, cp["ln_mlp"], cfg.norm_eps)
            return x + cp["gate_mlp"] * L.mlp(cp["mlp"], cfg, h)
        return gated
    return _patched(M, "_gated_residuals", wrap)


def _no_cross_attention_at_decode():
    import torch
    from repro_torch.models import model as M
    return _patched(M, "_cross_decode", lambda _: (
        lambda cp, cfg, x, xk, xv:
        M._gated_residuals(cp, cfg, x, torch.zeros_like(x))))


# name: (decode_impl, the kernels that launch, the fault or None)
PATHS = {
    "kernel": ("kernel", ("gqa_decode",), None),
    "torch path": ("torch", (), None),
    "plain version": ("kernel", (), _plain_version),
    "fp8 e4m3 K/V": ("kernel", ("gqa_decode",), _fp8_kv),
    "bf16 mean square": ("kernel", ("gqa_decode",), _bf16_mean_square),
    "gates without tanh": ("kernel", ("gqa_decode",), _gates_without_tanh),
    "no cross-attention at decode": ("kernel", ("gqa_decode",),
                                     _no_cross_attention_at_decode),
}


def _fault(name):
    fault = PATHS[name][2]
    return fault() if fault else contextlib.nullcontext()


def _serve(name, args, params, **kw):
    impl, need, _ = PATHS[name]
    with _fault(name):
        run, _ = C._serve_batch(args, params, need=need, impl=impl, **kw)
    run.cache = None
    return run


def _verdict(ratio, limit):
    return "fails" if ratio > limit else "passes"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("vlm_truth_controls: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(C.SRC))
    smi = C.phase_card()
    C.phase_build()
    from repro_torch.configs import base
    from repro_torch.models import model as M
    from repro_torch.training import tree
    cfg, params = C._p15_model()
    cfg32 = base.register(dataclasses.replace(
        cfg, dtype="float32", name=f"{cfg.name}-f32"))
    args_a = C.batch_args(cfg.name, C.P15_BATCH)
    args_b = C.batch_args(cfg.name, C.P15_TF)
    b, p, n = C.P15_TF
    fe_a = (torch.ones((C.P15_BATCH[0], cfg.frontend_tokens, cfg.d_model),
                       device=C.DEVICE) * 0.01).to(torch.bfloat16)
    fe_b = C._p15_frontend(cfg, b, torch.bfloat16)
    runs_a, runs_b, fwd_b = {}, {}, {}
    with torch.no_grad():
        for name in PATHS:
            tokens = runs_a["kernel"].prompt if runs_a else None
            runs_a[name] = _serve(name, args_a, params, tokens=tokens)
            tokens = runs_b["kernel"].prompt if runs_b else None
            run = runs_b[name] = _serve(name, args_b, params, tokens=tokens,
                                        frontend=fe_b)
            seq = torch.cat([run.prompt, run.tokens[:, :-1]], dim=1)
            fwd_b[name] = M.forward(params, cfg, {"tokens": seq,
                                                  "frontend": fe_b})[0][
                :, p - 1:].clone()
        p32 = tree.map(lambda t: t.float(), params)
        far_a = {k: C._p15_truth(cfg32, p32, C._p15_rows(r, fe_a))
                 for k, r in runs_a.items()}
        far_b = {}
        for name, run in runs_b.items():
            rows = C._p15_rows(run, fe_b)
            fwd_rows = [(pr, out, {j: fwd_b[name][r, j]
                                   for j in range(len(out))}, f)
                        for r, (pr, out, _, f) in enumerate(rows)]
            far_b[name] = (C._p15_truth(cfg32, p32, rows),
                           C._p15_truth(cfg32, p32, fwd_rows))
    rel32 = {}
    for name in PATHS:
        run = _serve(name, C.batch_args(cfg32.name, C.P15_TF), p32,
                     tokens=runs_b["kernel"].prompt, frontend=fe_b.float())
        seq = torch.cat([run.prompt, run.tokens[:, :-1]], dim=1)
        with torch.no_grad():
            f32 = M.forward(p32, cfg32, {"tokens": seq,
                                         "frontend": fe_b.float()})[0][
                :, p - 1:]
        rel32[name] = max(float((lg.float() - f32[:, j]).abs().max()
                                / f32[:, j].abs().max())
                          for j, lg in enumerate(run.logits))
        del f32
    a_b, _, a_n = C.P15_BATCH
    base_ulps = far_a["torch path"]
    for name, ulps in far_a.items():
        ratio = ulps / base_ulps
        flips = sum(x != y for x, y in zip(
            runs_a[name].tokens.flatten().tolist(),
            runs_a["torch path"].tokens.flatten().tolist()))
        verdict = _verdict(ratio, C.P15_TRUTH_RATIO)
        print(f"[controls] (a) {name}: {ulps:.2f} ulps from the f32 truth, "
              f"{ratio:.3f} x the torch path's ({verdict} the gate at "
              f"{C.P15_TRUTH_RATIO}); "
              f"{flips} of {a_b * a_n} tokens differ from the torch "
              f"path's ({smi})")
    for name, (dec, fwd) in far_b.items():
        print(f"[controls] (b) {name}: bf16 decode {dec:.2f} ulps from the "
              f"f32 truth, the sound bf16 forward {fwd:.2f}, "
              f"{dec / fwd:.3f} x ({_verdict(dec / fwd, C.P15_TRUTH_RATIO)} "
              f"at {C.P15_TRUTH_RATIO}); f32 decode vs the sound f32 "
              f"forward {rel32[name]:.3e} of max|logit| "
              f"({_verdict(rel32[name], C.P15_FWD_REL)} at "
              f"{C.P15_FWD_REL}) ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
