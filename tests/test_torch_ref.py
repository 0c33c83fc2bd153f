"""The port's kernel oracles (``repro_torch/kernels/ref.py``) against the JAX
package's oracles of the same names (``repro/kernels/ref.py``): the same
numpy-seeded f32 inputs through both, held to 1e-6 of the largest output
magnitude."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as TR

RTOL = 1e-6


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max())
    assert err <= RTOL * float(np.abs(want).max()), err


@pytest.mark.parametrize("b,s,hkv,qpk,hd", [(3, 40, 2, 4, 32),
                                            (2, 130, 1, 6, 64),
                                            (4, 17, 4, 1, 16)])
def test_gqa_decode_ref_matches_jax(b, s, hkv, qpk, hd):
    import jax.numpy as jnp
    from repro.kernels import ref as JR
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, hkv * qpk, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    lens = rng.integers(1, s + 1, b)
    valid = np.arange(s)[None, :] < lens[:, None]
    valid[0, 0] = False                        # a hole, not only a tail
    valid[0, -1] = True
    got = TR.gqa_decode_ref(*(torch.from_numpy(a) for a in (q, k, v, valid)))
    _close(got, JR.gqa_decode_ref(*(jnp.asarray(a) for a in (q, k, v, valid))))


@pytest.mark.parametrize("b,nb,bs,pages", [(3, 4, 8, 10), (2, 6, 16, 7)])
def test_paged_gqa_decode_ref_matches_jax(b, nb, bs, pages):
    """Stale entries past each row's length and rows aliasing one block
    included; the table is clamped to the pool alike."""
    import jax.numpy as jnp
    from repro.kernels import ref as JR
    rng = np.random.default_rng(1)
    hkv, qpk, hd = 2, 3, 32
    q = rng.standard_normal((b, hkv * qpk, hd)).astype(np.float32)
    kp = rng.standard_normal((pages, bs, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((pages, bs, hkv, hd)).astype(np.float32)
    tables = rng.integers(0, pages, (b, nb)).astype(np.int32)
    tables[1, 0] = tables[0, 0]
    seq = rng.integers(1, nb * bs + 1, b).astype(np.int32)
    args = (q, kp, vp, tables, seq)
    got = TR.paged_gqa_decode_ref(*(torch.from_numpy(a) for a in args))
    _close(got, JR.paged_gqa_decode_ref(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("n,zero_col", [(1, None), (7, 3), (64, None),
                                        (97, 10)])
def test_textrank_ref_matches_jax(n, zero_col):
    import jax.numpy as jnp
    from repro.kernels import ref as JR
    rng = np.random.default_rng(n)
    a = np.abs(rng.standard_normal((n, n))).astype(np.float32)
    sim = (a + a.T) / 2
    if zero_col is not None:                   # a dangling sentence
        sim[:, zero_col] = 0.0
        sim[zero_col, :] = 0.0
    got = TR.textrank_ref(torch.from_numpy(sim), damping=0.85, iters=30)
    _close(got, JR.textrank_ref(jnp.asarray(sim), damping=0.85, iters=30))
