"""The port's multi-head latent attention (``models.layers.mla_apply``)
against the JAX package's on the reduced deepseek-v2-lite-16b, with
K-F's plain version as its attention on the CPU.

Both forms: the expanded one (no cache; v zero-padded to the q·k width
for K-F) and the absorbed one (a cache: prefill into it, then decode
steps; MQA over the latent at d = kv_lora + rope). The absorbed form
computes the expanded one's function, so the port's two agree too.

Tolerances: float32 within 2e-5 abs + 2e-5 relative (the packages sum
the products in different orders; K-F's online softmax over 128-key
tiles against a full softmax). In bfloat16 the JAX absorbed form rounds
its probabilities to bfloat16 before probs·ckv while K-F keeps them in
float32 (as ROADMAP C9 records for the dense family): the outputs agree
to within 4 bfloat16 ulps of the output's largest value. Adds about 25
s to the suite (one process)."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models.layers import mla_apply as jmla_apply  # noqa: E402
from repro.models.layers import mla_init as jmla_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.layers import mla_apply, mla_cache  # noqa: E402

ATOL = RTOL = 2e-5
ARCH = "deepseek-v2-lite-16b"


def _setup(dtype=np.float32, seed=0, b=2, t=13):
    jcfg = jget_reduced(ARCH)
    cfg = configs.get_reduced(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = jmla_init(jax.random.PRNGKey(seed), jcfg, jdt)
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt), jp)
    x = np.random.default_rng(seed + 1).normal(
        size=(b, t, cfg.d_model)).astype(np.float32)
    return (jcfg, jp, jnp.asarray(x, jdt)), (cfg, tp,
                                             torch.from_numpy(x).to(tdt))


def _pos(b, lo, hi):
    p = np.broadcast_to(np.arange(lo, hi, dtype=np.int32)[None], (b, hi - lo))
    return jnp.asarray(p), torch.from_numpy(np.ascontiguousarray(p))


def _cache(cfg, b, n, dtype):
    c = cfg.mla
    return ({"ckv": jnp.zeros((b, n, c.kv_lora_rank), dtype),
             "k_rope": jnp.zeros((b, n, c.rope_head_dim), dtype),
             "pos": jnp.zeros((), jnp.int32)},
            mla_cache(b, n, c.kv_lora_rank, c.rope_head_dim,
                      torch.bfloat16 if dtype == jnp.bfloat16
                      else torch.float32, "cpu"))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               **(kw or dict(atol=ATOL, rtol=RTOL)))


def test_mla_expanded_matches_jax():
    """No cache: the expanded form on K-F (v padded 16 → 24), once."""
    (jcfg, jp, jx), (cfg, tp, tx) = _setup()
    jpos, tpos = _pos(2, 0, 13)
    want, _ = jmla_apply(jp, jx, jcfg, positions=jpos)
    ops.reset_launch_counts()
    got, cache = mla_apply(tp, tx, cfg, positions=tpos)
    assert cache is None
    _close(got, want)
    assert set(ops.launch_counts().values()) == {0}   # the CPU's plain K-F


def test_mla_absorbed_matches_jax():
    """With a cache: prefill 9 tokens, then 4 decode steps, each through
    the absorbed form; the cache holds JAX's latent and rope key."""
    (jcfg, jp, jx), (cfg, tp, tx) = _setup()
    jc, tc = _cache(cfg, 2, 16, jnp.float32)
    jpos, tpos = _pos(2, 0, 9)
    want, jc = jmla_apply(jp, jx[:, :9], jcfg, positions=jpos, cache=jc)
    got, tc = mla_apply(tp, tx[:, :9], cfg, positions=tpos, cache=tc,
                        pos=0)
    _close(got, want)
    for t in range(9, 13):
        jpos, tpos = _pos(2, t, t + 1)
        want, jc = jmla_apply(jp, jx[:, t:t + 1], jcfg, positions=jpos,
                              cache=jc)
        got, tc = mla_apply(tp, tx[:, t:t + 1], cfg, positions=tpos,
                            cache=tc, pos=t)
        _close(got, want)
    _close(tc["ckv"][:, :13], jc["ckv"][:, :13])
    _close(tc["k_rope"][:, :13], jc["k_rope"][:, :13])


def test_mla_absorbed_equals_expanded():
    """The port's absorbed prefill computes its expanded forward."""
    _, (cfg, tp, tx) = _setup(seed=4)
    _, tpos = _pos(2, 0, 13)
    full, _ = mla_apply(tp, tx, cfg, positions=tpos)
    _, tc = _cache(cfg, 2, 13, jnp.float32)
    absorbed, _ = mla_apply(tp, tx, cfg, positions=tpos, cache=tc, pos=0)
    _close(absorbed, full)


def test_mla_absorbed_bf16_within_one_rounding():
    """bfloat16: the absorbed decode against JAX's within 4 bfloat16 ulps
    of the largest output (JAX rounds the probabilities first)."""
    (jcfg, jp, jx), (cfg, tp, tx) = _setup("bf16", seed=7)
    jc, tc = _cache(cfg, 2, 16, jnp.bfloat16)
    jpos, tpos = _pos(2, 0, 12)
    _, jc = jmla_apply(jp, jx[:, :12], jcfg, positions=jpos, cache=jc)
    mla_apply(tp, tx[:, :12], cfg, positions=tpos, cache=tc, pos=0)
    jpos, tpos = _pos(2, 12, 13)
    want, _ = jmla_apply(jp, jx[:, 12:13], jcfg, positions=jpos, cache=jc)
    got, _ = mla_apply(tp, tx[:, 12:13], cfg, positions=tpos, cache=tc,
                       pos=12)
    want = np.asarray(want, np.float32)
    _close(got.float(), want,
           atol=4 * 2.0 ** -8 * float(np.abs(want).max()), rtol=0)
