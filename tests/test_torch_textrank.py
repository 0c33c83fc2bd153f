"""The port's TextRank (repro_torch.kernels.textrank) and the C&R
compressor that scores with it.

CPU: the plain PyTorch version against the JAX package's Pallas kernel
(``repro.kernels.ops.textrank_scores``, interpret mode off the TPU) and
its oracle ``repro.kernels.ref.textrank_ref`` on the same numpy inputs,
all in f32; the port's compressor with the plain scorer against the JAX
compressor with the Pallas scorer (same kept sentences, same text); and
the device dispatch of ``repro_torch.kernels.ops.textrank_scores``.
GPU (``-m gpu``, skipped without a card): the CUDA kernel against the
plain version on the card.

JAX is imported inside fixtures, never at module level, so the gpu
tests also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
        tests/test_torch_textrank.py
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import compression as TC
from repro_torch.kernels import ops
from repro_torch.kernels import textrank as TR
from repro_torch.serving.tokenizer import ByteChunkTokenizer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the gateway phase's prompt builders)

# f32 on every side; the sums run in other orders (and the kernel
# divides p by the column sums where the others normalise W first), so
# the vectors agree to a few f32 ulps of their largest entry
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores the other workers' tests time themselves on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_textrank():
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
    return (jax_ops.textrank_scores,
            lambda m: np.asarray(jax_ref.textrank_ref(jnp.asarray(m))))


def _sim(n, seed=None, zero_col=None):
    """Symmetric |normal| similarity matrix from a seed; ``zero_col``
    empties one sentence's row and column (a zero column sum)."""
    rng = np.random.default_rng(n if seed is None else seed)
    m = np.abs(rng.normal(size=(n, n))).astype(np.float32)
    m = (m + m.T) / 2
    if zero_col is not None:
        m[:, zero_col] = 0.0
        m[zero_col, :] = 0.0
    return m


def _within(got, want):
    err = np.abs(np.asarray(got, np.float64) - want).max()
    return err <= F32_TOL * np.abs(want).max()


@pytest.mark.parametrize("n,zero_col", [(1, None), (3, None), (50, None),
                                        (128, None), (257, None), (40, 5)],
                         ids=["1", "3", "50", "128", "257", "zero-column"])
def test_plain_matches_jax(jax_textrank, n, zero_col):
    pallas, oracle = jax_textrank
    m = _sim(n, zero_col=zero_col)
    got = TR.textrank_plain(torch.from_numpy(m)).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    assert _within(got, pallas(m))
    assert _within(got, oracle(m))
    if zero_col is not None:      # teleport mass only: (1 - d) / n
        assert abs(got[zero_col] - 0.15 / n) < 1e-7


def test_empty_and_single_sentence(jax_textrank):
    pallas, _ = jax_textrank
    empty = np.zeros((0, 0), np.float32)
    assert TR.textrank_plain(torch.from_numpy(empty)).shape == (0,)
    assert ops.textrank_scores(empty, device="cpu").shape == (0,)
    assert pallas(empty).shape == (0,)
    one = np.ones((1, 1), np.float32)
    got = ops.textrank_scores(one, device="cpu")
    assert np.allclose(got, pallas(one), rtol=0, atol=1e-7)
    assert np.allclose(got, 0.15, rtol=0, atol=1e-7)


def test_ops_routes_by_device():
    """numpy in, numpy out: ``device="cpu"`` scores with the plain
    version (no kernel launch) and an f64 matrix is cast to f32 first;
    the CUDA wrapper refuses a CPU tensor before any build or launch."""
    m = _sim(20).astype(np.float64)
    before = TR.KERNEL.launches
    got = ops.textrank_scores(m, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    want = TR.textrank_plain(torch.from_numpy(m.astype(np.float32)))
    assert np.array_equal(got, want.numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        TR.textrank_cuda(torch.from_numpy(m.astype(np.float32)))
    with pytest.raises(ValueError, match="no implementation"):
        ops.textrank_scores(m, device="meta")
    assert TR.KERNEL.launches == before
    assert ops.KERNELS[-1] is TR.KERNEL


def _kernel_test_text():
    """The text of tests/test_kernels.py::test_textrank_plugs_into_compressor."""
    return " ".join(f"Sentence number {i} about fleets queues and pools "
                    f"with extra detail {i % 7}." for i in range(30))


def _smoke_texts():
    """Two prompts of the gateway phase's kinds at its in-band size: varied
    sentences from the seeded word list, and the repetitive template."""
    tok = ByteChunkTokenizer(1024)
    rng = np.random.default_rng(0)
    return {"varied": chip_smoke.varied_prompt(rng, 800, tok),
            "template": chip_smoke.template_prompt(850, tok, "inband")}


@pytest.mark.parametrize("which", ["kernel-test", "varied", "template"])
def test_compressor_selects_like_jax_pallas(jax_textrank, which):
    """The port's compressor scoring with the plain version keeps the same
    sentences, and so the same text, as the JAX compressor scoring with
    the Pallas kernel (both f32 scorers)."""
    from repro.core.compression import ExtractiveCompressor as JaxCompressor
    from repro.core.compression import count_tokens
    pallas, _ = jax_textrank
    if which == "kernel-test":
        text = _kernel_test_text()
        budget = count_tokens(text) // 2
    else:
        text = _smoke_texts()[which]
        budget = 512 - 64            # T_c = B - L_out of the gateway phase
    port = TC.ExtractiveCompressor(
        textrank_fn=functools.partial(ops.textrank_scores, device="cpu"))
    ref = JaxCompressor(textrank_fn=pallas)
    a, b = port.compress(text, budget), ref.compress(text, budget)
    assert b.success and len(b.kept_indices) > 5
    assert a.kept_indices == b.kept_indices
    assert a.text == b.text and a.compressed_tokens == b.compressed_tokens
    assert a.compressed_tokens <= budget


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("n,zero_col", [(1, None), (64, None), (64, 7),
                                        (1024, None), (1500, 3)],
                         ids=["1", "64", "64-zero-column", "1024",
                              "1500-zero-column"])
def test_textrank_kernel_matches_plain(n, zero_col):
    """Staged (N <= 239) and L2-read (larger N) paths of the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    sim = torch.from_numpy(_sim(n, zero_col=zero_col)).cuda()
    before = TR.KERNEL.launches
    got = TR.textrank_cuda(sim)
    torch.cuda.synchronize()
    assert TR.KERNEL.launches == before + 1
    ref = TR.textrank_plain(sim)
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= F32_TOL * ref.abs().max().item()
    host = ops.textrank_scores(sim.cpu().numpy(), device="cuda",
                               stream=torch.cuda.Stream())
    assert np.array_equal(host, got.cpu().numpy())
