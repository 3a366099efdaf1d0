"""K-F's gradient on the CPU: ``flash_attention_bwd_plain`` (K-B's plain
version) and ``FlashAttentionFn`` against ``torch.autograd`` through
``flash_attention_plain`` and against ``jax.grad`` of the JAX package's
``_sdpa`` (the attention the JAX package trains through), for causal,
windowed, non-causal, GQA, rows that see no key and MLA's padded v; and
K-F's plain log-sum-exp against a float64 ``logsumexp``.

Tolerance: float32 inputs, each gradient within 1e-5 of its largest
entry (the three compute the same sums in other orders: tiled online
softmax, recomputed p from lse, XLA's full softmax); lse within 1e-5
abs. A row that sees no key has lse −inf and a zero gradient here; JAX's
softmax over no key is NaN, so that case is held against autograd only.
Single-process time ~11 s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro.models.layers import _sdpa  # noqa: E402
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

REL = 1e-5

# b, nq, nk, h, kvh, d, causal, window
CASES = {
    "causal-gqa": (2, 40, 40, 4, 2, 16, True, None),
    "windowed": (2, 70, 70, 4, 1, 16, True, 9),
    "non-causal": (2, 20, 45, 4, 4, 16, False, None),
    "decode-over-cache": (3, 5, 37, 6, 2, 8, True, None),
    "no-key-rows": (2, 40, 30, 4, 2, 16, True, None),
}


def _inputs(b, nq, nk, h, kvh, d, seed=0, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, nk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, nk, kvh, dv or d)).astype(np.float32)
    do = rng.standard_normal((b, nq, h, dv or d)).astype(np.float32)
    return q, k, v, do


def _close(got, want, what):
    lim = REL * float(np.abs(want).max()) + 1e-12
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= lim, f"{what}: {err:.3e} > {lim:.3e}"


def _autograd(q, k, v, do, **kw):
    ts = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
    out = kf.flash_attention_plain(*ts, bq=16, bk=16, **kw)
    return torch.autograd.grad(out, ts, torch.as_tensor(do))


def _jax_grads(q, k, v, do, *, causal, window, scale=None):
    rep = q.shape[2] // k.shape[2]
    off = k.shape[1] - q.shape[1]

    def f(q, k, v):
        kr, vr = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        if scale is not None:       # _sdpa scales by q's width ** -0.5
            q = q * (scale * q.shape[-1] ** 0.5)
        out = _sdpa(q, kr, vr, causal=causal, window=window, q_offset=off,
                    softcap=0.0)
        return jnp.sum(out * do)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_autograd_and_jax(case):
    b, nq, nk, h, kvh, d, causal, window = CASES[case]
    q, k, v, do = _inputs(b, nq, nk, h, kvh, d)
    kw = dict(causal=causal, window=window)
    tq, tk, tv, tdo = map(torch.as_tensor, (q, k, v, do))
    out, lse = kf.flash_attention_plain(tq, tk, tv, return_lse=True,
                                        bq=16, bk=16, **kw)
    assert torch.equal(out, kf.flash_attention_plain(tq, tk, tv, bq=16,
                                                     bk=16, **kw))
    got = kf.flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse, bq=16,
                                       bk=16, **kw)
    assert [g.shape for g in got] == [tq.shape, tk.shape, tv.shape]
    for name, g, a in zip("qkv", got, _autograd(q, k, v, do, **kw)):
        assert bool(torch.isfinite(g).all())
        _close(g.numpy(), a.numpy(), f"d{name} vs autograd")
    if case == "no-key-rows":
        blind = nq - nk                  # rows i < nq − nk see no key
        assert bool(torch.isinf(lse[:, :, :blind]).all())
        assert bool((lse[:, :, :blind] < 0).all())
        assert bool((got[0][:, :blind] == 0).all())
        assert bool(torch.isfinite(lse[:, :, blind:]).all())
        return
    for name, g, j in zip("qkv", got, _jax_grads(q, k, v, do, **kw)):
        _close(g.numpy(), np.asarray(j), f"d{name} vs jax.grad(_sdpa)")


@pytest.mark.parametrize("case", ["causal-gqa", "windowed", "non-causal",
                                  "no-key-rows"])
def test_lse_matches_float64_logsumexp(case):
    b, nq, nk, h, kvh, d, causal, window = CASES[case]
    q, k, v, _ = _inputs(b, nq, nk, h, kvh, d, seed=1)
    _, lse = kf.flash_attention_plain(*map(torch.as_tensor, (q, k, v)),
                                      causal=causal, window=window,
                                      return_lse=True, bq=16, bk=16)
    rep = h // kvh
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  np.repeat(k, rep, 2).astype(np.float64)) * d ** -0.5
    pos = np.arange(nq)[:, None] + nk - nq
    key = np.arange(nk)[None, :]
    mask = np.ones((nq, nk), bool)
    if causal:
        mask &= key <= pos
    if window is not None:
        mask &= key > pos - window
    with np.errstate(divide="ignore"):          # -inf: a row with no key
        want = np.log(np.where(mask, np.exp(s), 0.0).sum(-1))
    got = lse.numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-5


def test_flash_attention_fn_routes_and_pads_v():
    """``ops.flash_attention`` routes inputs that require grad through
    ``FlashAttentionFn`` (forward the same bits as without grad, backward
    the plain backward on the CPU, no kernel launch counted) — here at
    MLA's expanded form: q·k width 24 padded to 32 with zeros, v of 16
    padded to 32 and the output cut back, against ``jax.grad`` of
    ``_sdpa`` on the unpadded q, k and v; dv's padded columns are 0."""
    b, n, h, dq, dv, width = 2, 33, 4, 24, 16, 32
    q, k, v, do = _inputs(b, n, n, h, h, dq, seed=2, dv=dv)
    scale = dq ** -0.5
    ts = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
    ops.reset_launch_counts()
    vp = F.pad(ts[2], (0, width - dv))
    vp.retain_grad()
    out = ops.flash_attention(F.pad(ts[0], (0, width - dq)),
                              F.pad(ts[1], (0, width - dq)), vp,
                              causal=True, scale=scale)
    assert out.grad_fn is not None
    with torch.no_grad():
        plain = ops.flash_attention(F.pad(ts[0], (0, width - dq)),
                                    F.pad(ts[1], (0, width - dq)),
                                    F.pad(ts[2], (0, width - dv)),
                                    causal=True, scale=scale)
    assert torch.equal(out.detach(), plain)
    out[..., :dv].backward(torch.as_tensor(do))
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    assert bool((vp.grad[..., dv:] == 0).all())
    want = _jax_grads(q, k, v, do, causal=True, window=None, scale=scale)
    for name, t, j in zip("qkv", ts, want):
        assert t.grad.shape == t.shape
        _close(t.grad.numpy(), np.asarray(j), f"d{name}")


def test_bwd_cuda_refuses_cpu_tensors():
    """K-B's wrapper launches its kernel or raises: a CPU tensor is
    refused, and nothing is counted (the card test
    ``test_flash_attention_bwd_refuses_wide_heads`` checks the head
    width)."""
    q = torch.zeros((1, 4, 2, 16))
    lse = torch.zeros((1, 2, 4))
    before = kf.bwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        kf.flash_attention_bwd_cuda(q, q, q, q, q, lse)
    assert kf.bwd_launches == before
