"""K-F's plain version (``kernels.flash_attention.flash_attention_plain``)
against the JAX package's Pallas ``flash_attention_pallas`` in interpret
mode and its jnp reference ``ref.flash_attention_ref``, on the same numpy
inputs.

Tolerance: float32 within 1e-5 abs — both walk the same (bq, bk) tiles
with the same online softmax in float32, and differ only in the order
their dot products and row sums add up (~1e-7 relative on these values);
the reference takes one softmax over the whole row, no closer than that.
bfloat16 within 5e-2 abs, the JAX package's own bf16 test's tolerance
(both round the float32 output to bf16 once; the reference also rounds p
to bf16 before p·v)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

F32_ATOL = 1e-5
BF16_ATOL = 5e-2


def _inputs(b, nq, nk, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, nq, h, d)).astype(np.float32),
            rng.normal(size=(b, nk, kvh, d)).astype(np.float32),
            rng.normal(size=(b, nk, kvh, d)).astype(np.float32))


# the shapes of tests/test_kernels.py::test_flash_attention, plus dh = 128
@pytest.mark.parametrize("nq,nk,h,kvh,window,causal,d", [
    (64, 64, 4, 4, None, True, 16),
    (64, 64, 4, 1, None, True, 16),      # MQA
    (32, 96, 8, 2, None, True, 16),      # GQA + decode-style offset
    (64, 64, 4, 2, 16, True, 16),        # local window
    (48, 48, 2, 2, None, False, 16),     # bidirectional (encoder)
    (40, 72, 4, 2, None, True, 128),     # a full-width head, ragged tiles
])
def test_plain_matches_pallas_interpret_and_ref(nq, nk, h, kvh, window,
                                                causal, d):
    q, k, v = _inputs(2, nq, nk, h, kvh, d, nq + nk + d)
    got = kf.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, bq=16, bk=16).numpy()
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, bq=16, bk=16,
                                  interpret=True)
    oracle = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=0,
                               atol=F32_ATOL)


def test_default_tiles_and_decode_step():
    """The default 128-wide tiles, and a single decode row over 300 keys
    (the tile skip on the right-aligned query) with a window."""
    for nq, nk, window in ((200, 200, None), (1, 300, None), (1, 300, 100),
                           (130, 300, 37)):
        q, k, v = _inputs(2, nq, nk, 6, 2, 32, nq + nk)
        got = kf.flash_attention_plain(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            window=window).numpy()
        want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), window=window,
                                      interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=F32_ATOL)


def test_bf16_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    x = [rng.normal(size=(1, 32, 2, 8)).astype(np.float32) for _ in range(3)]
    got = kf.flash_attention_plain(
        *[torch.from_numpy(a).to(torch.bfloat16) for a in x], bq=16, bk=16)
    assert got.dtype == torch.bfloat16
    want = flash_attention_pallas(*[jnp.asarray(a).astype(jnp.bfloat16)
                                    for a in x], bq=16, bk=16,
                                  interpret=True)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=BF16_ATOL)


def test_row_that_sees_no_key_is_zero():
    """More queries than keys: the first nq − nk rows sit before key 0
    and see nothing; both packages give 0 there (not NaN)."""
    q, k, v = _inputs(2, 20, 7, 4, 1, 16, 5)
    got = kf.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), bq=16,
                                   bk=16).numpy()
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=16, bk=16,
        interpret=True))
    assert (got[:, :13] == 0).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_cpu_dispatch_and_scale():
    """``ops.flash_attention`` takes the plain version on CPU tensors
    (no launch counted); an explicit ``scale`` is the JAX package's."""
    q, k, v = _inputs(1, 24, 24, 4, 2, 16, 3)
    ops.reset_launch_counts()
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=0.3).numpy()
    assert ops.launch_counts()["flash_attention"] == 0
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), scale=0.3, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=F32_ATOL)
