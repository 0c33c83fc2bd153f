"""The port's decode kernels (repro_torch.kernels).

CPU: the plain PyTorch versions against the JAX package's Pallas kernels
(``repro.kernels.ops``, interpret mode off the TPU) on the same numpy
inputs, and the device dispatch of ``repro_torch.kernels.ops``.
GPU (``-m gpu``, skipped without a card): each CUDA kernel against its
plain version on the card.

JAX is imported inside fixtures, never at module level, so the gpu
tests also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \
        tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gqa_decode as D
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as PD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores the other workers' tests time themselves on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# f32 on both sides; the Pallas kernel accumulates blockwise online, the
# plain version takes one softmax: agreement to ~1e-6 relative
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def jops():
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops
    return jnp, jax_ops


def _dense_case(qpk, seed=0, b=3, s=64, hkv=2, hd=64):
    rng = np.random.default_rng(seed)
    h = hkv * qpk
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    j = np.arange(s)
    valid = np.stack([j < 40, j < 1,
                      # ring-buffer window: two disjoint valid ranges
                      ((j >= 5) & (j < 20)) | ((j >= 50) & (j < 60))])
    active = np.array([True, False, True])
    return q, k, v, valid, active


def _paged_case(qpk, seed=0, b=3, nb=4, bs=16, hkv=2, hd=64):
    rng = np.random.default_rng(seed)
    h = hkv * qpk
    p = 10
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((p, bs, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((p, bs, hkv, hd)).astype(np.float32)
    tables = np.array([[3, 7, 1, 99],       # last entry stale (past P)
                       [3, 0, -4, 2],       # aliases row 0's block 3
                       [9, 8, 6, 5]], np.int32)
    seq_lens = np.array([40, 17, 64], np.int32)   # ragged
    active = np.array([True, True, False])
    return q, k, v, tables, seq_lens, active


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("qpk", [1, 4])
def test_gqa_decode_plain_matches_pallas(jops, qpk):
    jnp, jax_ops = jops
    q, k, v, valid, active = _dense_case(qpk)
    ref = np.asarray(jax_ops.gqa_decode(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(valid),
                                        jnp.asarray(active)))
    got = ops.gqa_decode(*_t(q, k, v, valid, active)).numpy()
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()
    assert (got[~active] == 0).all()


@pytest.mark.parametrize("qpk", [1, 4])
def test_paged_gqa_decode_plain_matches_pallas(jops, qpk):
    jnp, jax_ops = jops
    q, k, v, tables, seq_lens, active = _paged_case(qpk)
    ref = np.asarray(jax_ops.paged_gqa_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(seq_lens), jnp.asarray(active)))
    got = ops.paged_gqa_decode(*_t(q, k, v, tables, seq_lens,
                                   active)).numpy()
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()
    assert (got[~active] == 0).all()


def test_plain_inactive_rows_exact_zero_bf16():
    q, k, v, valid, active = _dense_case(2)
    tq, tk, tv, tvalid, tact = _t(q, k, v, valid, active)
    out = D.gqa_decode_plain(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(),
                             tvalid, tact)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[1], torch.zeros_like(out[1]))


def test_paged_plain_equals_dense_plain_on_gathered_rows():
    """The paged plain version is the dense one on rows gathered through
    the clamped block tables (what gather_pages materializes)."""
    q, k, v, tables, seq_lens, active = _paged_case(2)
    tq, tk, tv, tt, ts, ta = _t(q, k, v, tables, seq_lens, active)
    bt = tt.long().clamp(0, tk.shape[0] - 1)
    kd = tk[bt].reshape(3, -1, *tk.shape[2:])
    vd = tv[bt].reshape(3, -1, *tv.shape[2:])
    valid = torch.arange(kd.shape[1])[None, :] < ts[:, None]
    assert torch.equal(PD.paged_gqa_decode_plain(tq, tk, tv, tt, ts, ta),
                       D.gqa_decode_plain(tq, kd, vd, valid, ta))


def test_ops_routes_by_device():
    q, k, v, valid, active = _t(*_dense_case(1))
    with pytest.raises(ValueError, match="no implementation"):
        ops.gqa_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                       valid.to("meta"), active.to("meta"))
    q, k, v, tables, seq_lens, active = _t(*_paged_case(1))
    with pytest.raises(ValueError, match="no implementation"):
        ops.paged_gqa_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                             tables.to("meta"), seq_lens.to("meta"),
                             active.to("meta"))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back to the plain version: a CPU
    tensor handed to them raises before any build or launch."""
    before = (D.KERNEL.launches, PD.KERNEL.launches)
    q, k, v, valid, active = _t(*_dense_case(1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        D.gqa_decode_cuda(q, k, v, valid, active)
    q, k, v, tables, seq_lens, active = _t(*_paged_case(1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        PD.paged_gqa_decode_cuda(q, k, v, tables, seq_lens, active)
    assert (D.KERNEL.launches, PD.KERNEL.launches) == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False


# bf16: both sides accumulate in f32 and round once at the end, so an
# output may land one bf16 ulp (<= 2^-7 of its magnitude) from the other
BF16_TOL = 1e-2


def _close(got, ref, dtype):
    """Max abs error within the tolerance times max |plain|, no floor:
    attention outputs over many random tokens are well under 1."""
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    err = (got.float() - ref.float()).abs().max().item()
    return err <= tol * ref.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qpk", [1, 2, 4, 8])
def test_gqa_decode_kernel_matches_plain(qpk, dtype):
    _require_cuda()
    q, k, v, valid, active = [t.cuda() for t in _t(*_dense_case(qpk))]
    _check_dense(q, k, v, valid, active, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_decode_kernel_many_splits(dtype):
    """S = 1000: several splits of S, a ragged last tile, and a row whose
    valid tokens sit in two splits only."""
    _require_cuda()
    q, k, v, _, active = [t.cuda() for t in _t(*_dense_case(4, s=1000))]
    j = torch.arange(1000, device="cuda")
    valid = torch.stack([j < 999, j < 300,
                         ((j >= 200) & (j < 260)) | (j >= 900)])
    _check_dense(q, k, v, valid.contiguous(), active, dtype)


def _check_dense(q, k, v, valid, active, dtype):
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = D.KERNEL.launches
    got = D.gqa_decode_cuda(q, k, v, valid, active)
    torch.cuda.synchronize()
    assert D.KERNEL.launches == before + 1
    assert _close(got, D.gqa_decode_plain(q, k, v, valid, active), dtype)
    assert (got[~active] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qpk", [1, 2, 4, 8])
def test_paged_gqa_decode_kernel_matches_plain(qpk, dtype):
    _require_cuda()
    q, k, v, tables, seq_lens, active = [
        t.cuda() for t in _t(*_paged_case(qpk))]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    got = PD.paged_gqa_decode_cuda(q, k, v, tables, seq_lens, active)
    torch.cuda.synchronize()
    ref = PD.paged_gqa_decode_plain(q, k, v, tables, seq_lens, active)
    assert _close(got, ref, dtype)
    assert (got[~active] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_gqa_decode_kernel_many_splits(dtype):
    """64 blocks of 16 per row (several splits), ragged seq_lens, stale
    entries past each row's length, and two rows sharing a block."""
    _require_cuda()
    rng = np.random.default_rng(1)
    b, nb, bs, hkv, hd, p = 3, 64, 16, 2, 128, 200
    q = rng.standard_normal((b, 4 * hkv, hd)).astype(np.float32)
    k = rng.standard_normal((p, bs, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((p, bs, hkv, hd)).astype(np.float32)
    tables = rng.permutation(p)[: b * nb].reshape(b, nb).astype(np.int32)
    tables[2, 0] = tables[0, 0]
    seq_lens = np.array([1000, 17, 700], np.int32)
    for r, n in enumerate(seq_lens):
        tables[r, -(-n // bs):] = 10_000 if r % 2 else -3
    q, k, v, tables, seq_lens, active = [
        t.cuda() for t in _t(q, k, v, tables, seq_lens,
                             np.array([True, True, True]))]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    got = PD.paged_gqa_decode_cuda(q, k, v, tables, seq_lens, active)
    ref = PD.paged_gqa_decode_plain(q, k, v, tables, seq_lens, active)
    assert _close(got, ref, dtype)


@pytest.mark.gpu
def test_gqa_decode_kernel_reads_through_strides():
    """A (B, S, Hkv, hd) view of a longer per-row buffer (batch stride >
    S*Hkv*hd, as in a cache sliced to its first S tokens) gives the same
    output as a compact copy."""
    _require_cuda()
    q, k, v, valid, active = [t.cuda() for t in _t(*_dense_case(2))]
    s = k.shape[1]
    big_k = torch.zeros((k.shape[0], s + 8, *k.shape[2:]), device="cuda")
    big_v = torch.zeros_like(big_k)
    big_k[:, :s], big_v[:, :s] = k, v
    assert big_k[:, :s].stride(0) > s * k.shape[2] * k.shape[3]
    got = D.gqa_decode_cuda(q, big_k[:, :s], big_v[:, :s], valid, active)
    assert torch.equal(got, D.gqa_decode_cuda(q, k, v, valid, active))


@pytest.mark.gpu
def test_kernel_wrappers_reject_unsupported_shapes():
    _require_cuda()
    q, k, v, valid, active = [t.cuda() for t in _t(*_dense_case(1, hd=32))]
    with pytest.raises(ValueError, match="head_dim"):
        D.gqa_decode_cuda(q, k, v, valid, active)
    q, k, v, valid, active = [t.cuda() for t in _t(*_dense_case(1))]
    with pytest.raises(ValueError, match="valid"):
        D.gqa_decode_cuda(q, k, v, valid.int(), active)
