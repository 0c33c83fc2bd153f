"""The port's training launcher (``repro_torch.launch.train``) against
``repro.launch.train`` on the JAX launcher's weights, and checkpoints
crossing between the two packages (``repro_torch.training.checkpoint``
and ``repro.training.checkpoint``): each restores the other's, f32 and
bf16, bit for bit, and a bf16 tree's saved leaves are the JAX package's
bytes.

The JAX launcher builds its 1x1 mesh with ``jax.make_mesh``; it is given
Auto axes, the sharding mode it was written for (this JAX's default,
Explicit, refuses the embedding gather it traces), as in
tests/test_torch_forward.py. Its lines and the port's are compared at
their printed precision, the seconds a step left out.
"""
import contextlib
import io
import re
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import model as M
from repro.training import checkpoint as JCK
from repro.training import optimizer as JO
from repro_torch import params as P
from repro_torch.launch import train as TL
from repro_torch.training import checkpoint as TCK
from repro_torch.training import optimizer as TO
from repro_torch.training import tree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(text):
    """The launcher's lines without the seconds a step."""
    return [re.sub(r" \([0-9.]+s/step\)$", "", ln)
            for ln in text.splitlines()]


def _both_launchers(argv, cfg, monkeypatch, tmp_path):
    """``argv`` through ``repro.launch.train.main`` (Auto mesh axes) and
    the port's ``train`` on the JAX launcher's weights (PRNGKey(0)), each
    with a ``--ckpt-dir`` of its own under ``tmp_path``. Returns (the
    port's lines, the JAX launcher's, the port's run, the JAX
    weights)."""
    from jax.sharding import AxisType
    from repro.launch import train as JL
    jparams = jax.tree.map(np.asarray,
                           M.init_params(cfg, jax.random.PRNGKey(0)))
    make_mesh = jax.make_mesh
    monkeypatch.setattr(jax, "make_mesh", lambda shape, names, **kw:
                        make_mesh(shape, names,
                                  axis_types=(AxisType.Auto,) * len(names)))
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--ckpt-dir", str(tmp_path / "jax")])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JL.main()
    want = _lines(buf.getvalue())
    out = []
    run = TL.train(TL.parse_args(argv + ["--device", "cpu", "--ckpt-dir",
                                         str(tmp_path / "port")]),
                   params=P.from_jax_numpy(jparams, device="cpu"),
                   log=out.append)
    return _lines("\n".join(out)), want, run, jparams


def test_launcher_prints_jax_lines(monkeypatch, tmp_path):
    """``--reduced --steps 4`` through both launchers from the JAX
    launcher's weights (PRNGKey(0)): the same mesh, step and checkpoint
    lines; the port's checkpoint restores through the JAX package."""
    cfg = reduced_f32("minitron-8b")
    got, want, run, jparams = _both_launchers(["--reduced", "--steps", "4"],
                                              cfg, monkeypatch, tmp_path)
    assert got[0] == want[0] == f"mesh 1x1 (1 devices), arch={cfg.name}"
    assert got[1:5] == want[1:5]
    assert [ln.split(" to ")[0] for ln in (got[5], want[5])] == \
        ["saved checkpoint"] * 2
    assert len(got) == len(want) == 6
    assert len(run.losses) == len(run.step_s) == 4
    back = JCK.restore(str(tmp_path / "port"), 4, jparams)
    for a, b in zip(jax.tree.leaves(back), tree.leaves(run.params)):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("arch,extra", [
    ("llama-3.2-vision-11b", []),
    ("seamless-m4t-large-v2", ["--microbatches", "2"])],
    ids=["vlm", "encdec-microbatches-2"])
def test_launcher_with_a_frontend_prints_jax_lines(monkeypatch, tmp_path,
                                                   arch, extra):
    """A model with a frontend (VLM, ENCDEC): both launchers put the
    reference's stub, ``ones * 0.01`` (global_batch, frontend_tokens,
    d_model), into every batch (the microbatch split cuts it on axis 0
    with the tokens), and print the same step lines from the JAX
    launcher's weights; every loss finite."""
    cfg = reduced_f32(arch)
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--global-batch",
            "4", "--seq-len", "16"] + extra
    got, want, run, _ = _both_launchers(argv, cfg, monkeypatch, tmp_path)
    assert got[0] == want[0] == f"mesh 1x1 (1 devices), arch={cfg.name}"
    assert got[1:4] == want[1:4]
    assert len(got) == len(want) == 5
    assert all(np.isfinite(x) for x in run.losses + run.gnorms)


def test_launcher_refuses_a_mesh():
    args = TL.parse_args(["--reduced", "--mesh", "2x1", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="later slice"):
        TL.train(args)


def test_launcher_microbatches_and_one_device_flags():
    """``--microbatches 2`` runs; ``--zero1`` and
    ``--no-sequence-parallel`` change nothing on one device."""
    base = ["--reduced", "--steps", "2", "--global-batch", "4",
            "--seq-len", "16", "--device", "cpu"]
    a = TL.train(TL.parse_args(base), log=lambda s: None)
    b = TL.train(TL.parse_args(base + ["--zero1", "--no-sequence-parallel"]),
                 log=lambda s: None)
    c = TL.train(TL.parse_args(base + ["--microbatches", "2"]),
                 log=lambda s: None)
    assert a.losses == b.losses
    assert all(torch.equal(x, y) for x, y in
               zip(tree.leaves(a.params), tree.leaves(b.params)))
    assert c.losses[0] == pytest.approx(a.losses[0], rel=1e-5)


# ------------------------------------------------------------ checkpoints
def _trees(dtype):
    """JAX params and AdamW state (three updates in, so the moments and
    step are not their initial values) and the port's copies."""
    rng = np.random.default_rng(0)

    def a(*shape):
        return jnp.asarray(rng.standard_normal(shape), dtype)
    jp = {"layers": {"w": a(2, 4, 6), "ln": a(2, 4)}, "embed": a(10, 4)}
    js = JO.init_adamw(jp)
    cfg = JO.AdamWConfig(warmup_steps=1)
    for _ in range(3):
        jp, js, _ = JO.adamw_update(cfg, jax.tree.map(lambda x: x * 3, jp),
                                    js, jp)
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    return jp, js, P.from_jax_numpy(jp, device="cpu"), \
        P.adamw_from_jax_numpy(js, device="cpu")


def _bits(x):
    """The bytes of a leaf: numpy (JAX's, raw |V2 for bf16) or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    x = np.asarray(x)
    return (x.view(np.int16) if x.dtype.itemsize == 2 else x).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_through_jax(tmp_path, dtype):
    jp, js, tp, ts = _trees(dtype)
    TCK.save(str(tmp_path), 3, tp, ts)
    back = JCK.restore(str(tmp_path), 3, {"params": jp, "opt": js})
    assert int(back["opt"].step) == 3
    want = jax.tree.leaves({"params": jp, "opt": js})
    got = jax.tree.leaves(back)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert a.shape == b.shape and _bits(a) == _bits(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_through_port(tmp_path, dtype):
    jp, js, tp, ts = _trees(dtype)
    JCK.save(str(tmp_path), 3, jp, js)
    assert TCK.latest_step(str(tmp_path)) == 3
    like = {"params": tree.unflatten(tp, [torch.zeros_like(x) for x in
                                          tree.leaves(tp)]),
            "opt": TO.init_adamw(tp)}
    back = TCK.restore(str(tmp_path), 3, like)
    assert back["opt"].step.dtype == torch.int32 and int(back["opt"].step) == 3
    for a, b in zip(tree.leaves(back), tree.leaves({"params": tp,
                                                    "opt": ts})):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bf16_leaf_bytes_equal_jax(tmp_path):
    """The same bf16 params and f32 optimizer state saved by both
    packages: every member of the two .npz files is the same bytes (the
    bf16 leaves' '<V2' headers included)."""
    jp, js, tp, ts = _trees("bfloat16")
    JCK.save(str(tmp_path / "jax"), 3, jp, js)
    TCK.save(str(tmp_path / "port"), 3, tp, ts)
    name = "ckpt_00000003.npz"
    with zipfile.ZipFile(tmp_path / "jax" / name) as zj, \
            zipfile.ZipFile(tmp_path / "port" / name) as zt:
        assert zj.namelist() == zt.namelist()
        for member in zj.namelist():
            assert zj.read(member) == zt.read(member), member
    with np.load(tmp_path / "port" / name) as data:
        # leaf 0 the step, 1-3 m, 4-6 v, 7-9 the params
        assert data["leaf_7"].dtype.str == "|V2"
        assert data["leaf_4"].dtype == np.float32
