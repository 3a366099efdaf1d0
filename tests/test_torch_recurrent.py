"""The port's recurrent cells (``repro_torch.models.recurrent``) against
the JAX package's ``models.recurrent`` on the reduced xlstm-350m and
recurrentgemma-9b configs: the causal conv, RG-LRU, mLSTM and sLSTM over
a full sequence, as a prefill that continues from a carried state, and
as decode steps; the states they return, with their dtypes; and the
float32 leaves of a bfloat16 init.

The JAX parameters are drawn from a seed, the zero-initialised gate
vectors replaced by seeded numpy values (so every gate does work), and
carried across as tensors; the inputs are the same seeded numpy arrays.

Tolerance: outputs and states within 2e-5 abs + 2e-5 relative in
float32. The packages sum in different orders (XLA's dot vs torch's
matmul; RG-LRU's log-depth scan is JAX's ``associative_scan`` there and a
Hillis–Steele scan here, its gates float32 there and float64 rounded
once here; mLSTM's three-operand einsum contracts in another order); the worst seen at these seeds is 3.8e-6 abs, 0.09 of
the limit. About 20 s (JAX's cells jitted once per shape)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import ModelOptions, init_params  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402

ATOL = RTOL = 2e-5
CELLS = {"rglru": "recurrentgemma-9b", "mlstm": "xlstm-350m",
         "slstm": "xlstm-350m"}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _states_equal(got, want):
    """Same keys, dtypes and values (within the tolerance)."""
    assert set(got) == set(want)
    for k in want:
        assert str(got[k].dtype).removeprefix("torch.") == \
            str(want[k].dtype), k
        _close(got[k], want[k])


def _cell(kind, seed=0):
    """(JAX params, port params, config) of one cell, the zero gate
    vectors replaced by seeded values."""
    jcfg = jget_reduced(CELLS[kind])
    cfg = configs.get_reduced(CELLS[kind])
    jp = getattr(JR, f"{kind}_block_init")(jax.random.PRNGKey(seed), jcfg,
                                           jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(seed + 10)
    for name in ("w_a", "b_a", "w_x", "b_x"):
        if name in jp:
            jp[name] = rng.normal(size=jp[name].shape).astype(np.float32)
    return jp, _to_torch(jp), cfg, jcfg


def _x(cfg, t, seed, b=2):
    return np.random.default_rng(seed).normal(
        size=(b, t, cfg.d_model)).astype(np.float32)


def test_conv1d_full_and_carried():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for state in (None, st):
        got = R.conv1d_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                             None if state is None else torch.from_numpy(st))
        want = JR.conv1d_apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                               None if state is None else jnp.asarray(st))
        for g, w_ in zip(got, want):
            _close(g, w_)


@pytest.mark.parametrize("kind,t", [("rglru", 37), ("mlstm", 70),
                                    ("mlstm", 128), ("slstm", 23)])
def test_cell_matches_jax(kind, t):
    """A full sequence from no state, a prefill of 11 tokens carrying that
    state on, and three decode steps: outputs and states (dtypes
    included) as the JAX package's. mLSTM at 70 tokens pads its second
    chunk (70 is no multiple of 64)."""
    jp, p, cfg, jcfg = _cell(kind)
    apply = getattr(R, f"{kind}_block_apply")
    japply = jax.jit(getattr(JR, f"{kind}_block_apply"), static_argnums=2)
    x = _x(cfg, t, 1)
    got, st = apply(p, torch.from_numpy(x), cfg)
    want, jst = japply(jp, jnp.asarray(x), jcfg)
    _close(got, want)
    _states_equal(st, jst)
    x2 = _x(cfg, 11, 2)
    got, st = apply(p, torch.from_numpy(x2), cfg, state=st)
    want, jst = japply(jp, jnp.asarray(x2), jcfg, jst)
    _close(got, want)
    _states_equal(st, jst)
    for s in range(3):
        x1 = _x(cfg, 1, 3 + s)
        got, st = apply(p, torch.from_numpy(x1), cfg, state=st)
        want, jst = japply(jp, jnp.asarray(x1), jcfg, jst)
        _close(got, want)
        _states_equal(st, jst)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_init_state_matches_jax(kind):
    """The initial states: shapes, dtypes and values (bfloat16 model)."""
    cfg = configs.get_reduced(CELLS[kind])
    jcfg = jget_reduced(CELLS[kind])
    got = getattr(R, f"{kind}_init_state")(cfg, 3, torch.bfloat16, "cpu")
    want = getattr(JR, f"{kind}_init_state")(jcfg, 3, jnp.bfloat16)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == \
            str(want[k].dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))


def test_decode_from_empty_state_matches_jax():
    """A decode step with no state (each cell makes its own initial
    state) as the JAX package's."""
    for kind in sorted(CELLS):
        jp, p, cfg, jcfg = _cell(kind, seed=3)
        x1 = _x(cfg, 1, 7)
        got, st = getattr(R, f"{kind}_block_apply")(p, torch.from_numpy(x1),
                                                    cfg)
        want, jst = getattr(JR, f"{kind}_block_apply")(jp, jnp.asarray(x1),
                                                       jcfg)
        _close(got, want)
        _states_equal(st, jst)


def test_bf16_init_keeps_float32_leaves():
    """In a bfloat16 model ``lam``, ``fgate_bias`` and ``f_bias`` are
    float32 and every other leaf bfloat16, as in the JAX package's init;
    the cells run in bfloat16 and return their states in JAX's dtypes."""
    for arch in ("recurrentgemma-9b", "xlstm-350m"):
        cfg = configs.get_reduced(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             ModelOptions(dtype=torch.bfloat16), device="cpu")
        seen = set()

        def walk(tree, name=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, k)
            elif isinstance(tree, list):
                for v in tree:
                    walk(v, name)
            else:
                want = (torch.float32 if name in R.FLOAT32_LEAVES
                        else torch.bfloat16)
                assert tree.dtype == want, (arch, name, tree.dtype)
                seen.add(name)

        walk(params)
        assert seen & set(R.FLOAT32_LEAVES)
    jcfg = jget_reduced("xlstm-350m")
    for kind, leaf in (("mlstm", "fgate_bias"), ("slstm", "f_bias")):
        jp = getattr(JR, f"{kind}_block_init")(jax.random.PRNGKey(0), jcfg,
                                               jnp.bfloat16)
        assert jp[leaf].dtype == jnp.float32
    cfg = configs.get_reduced("xlstm-350m")
    for kind in ("mlstm", "slstm"):
        p = getattr(R, f"{kind}_block_init")(torch.Generator().manual_seed(1),
                                             cfg, torch.bfloat16, "cpu")
        x = torch.from_numpy(_x(cfg, 5, 0)).to(torch.bfloat16)
        y, st = getattr(R, f"{kind}_block_apply")(p, x, cfg)
        assert y.dtype == torch.bfloat16
        want = {"mlstm": {"C": torch.float32, "n": torch.float32,
                          "m": torch.float32, "conv": torch.bfloat16},
                "slstm": dict.fromkeys("hcnm", torch.bfloat16)}[kind]
        assert {k: v.dtype for k, v in st.items()} == want
