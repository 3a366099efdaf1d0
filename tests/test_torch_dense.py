"""The dense top-k (K-D's plain version, ``kernels.distance_topk.
distance_topk_plain``) against the JAX package's Pallas
``distance_topk_pallas`` in interpret mode and its jnp reference
``ref.distance_topk_ref``, on the same numpy inputs.

Tolerance: the two packages sum d² = ‖r‖²+‖s‖²−2r·s in different
orders (XLA's dot vs torch's matmul), so squared distances agree within
2⁻¹⁸ of the largest ‖r‖²+‖s‖² (``torch_parity.assert_d_close``); ids
are equal except where the two distances tie within that limit. The
port sends exact ties to the lower row id."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.distance_topk import distance_topk_pallas  # noqa: E402
from repro_torch.kernels import distance_topk as kd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from torch_parity import assert_d_close  # noqa: E402

BM, BN = 32, 128


def _inputs(d, seed=0, n_r=40, n_s=300):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n_r, d)).astype(np.float32)
    s = rng.normal(size=(n_s, d)).astype(np.float32)
    s[200] = s[17]              # duplicate rows: tied distances
    r[3] = s[17]                # ... at distance 0 from query 3
    return r, s


def _assert_same_run(got_d, got_i, want_d, want_i, rows):
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    assert_d_close(got_d, want_d, rows)
    atol = 2.0 ** -18 * 2 * float((rows.astype(np.float64) ** 2)
                                  .sum(1).max())
    mism = got_i != want_i
    assert (np.abs(got_d[mism].astype(np.float64) ** 2
                   - want_d[mism].astype(np.float64) ** 2) <= atol).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [3, 16, 200])
def test_plain_matches_pallas_interpret(d, masked):
    """n_s = 300 is no multiple of bn = 128 (the last S tile is ragged);
    the mask drops about half the tiles but keeps tile 0 of each R tile,
    so every query keeps ≥ k candidates."""
    r, s = _inputs(d, seed=d)
    k = 7
    mask = None
    if masked:
        mask = (np.random.default_rng(d + 1).random((2, 3)) < 0.5) \
            .astype(np.int8)
        mask[:, 0] = 1
    jd, ji = distance_topk_pallas(
        jnp.asarray(r), jnp.asarray(s), k, bm=BM, bn=BN, interpret=True,
        visit_mask=None if mask is None else jnp.asarray(mask))
    pd, pi = kd.distance_topk_plain(
        torch.from_numpy(r), torch.from_numpy(s), k, bm=BM, bn=BN,
        visit_mask=None if mask is None else torch.from_numpy(mask))
    assert pd.dtype == torch.float32 and pi.dtype == torch.int32
    _assert_same_run(pd, pi, jd, ji, np.concatenate([r, s]))
    if not masked:
        rd, ri = ref.distance_topk_ref(jnp.asarray(r), jnp.asarray(s), k)
        _assert_same_run(pd, pi, rd, ri, np.concatenate([r, s]))


def test_ties_go_to_the_lower_id():
    """Integer-valued rows make every d² exact, so duplicate rows tie
    exactly: the port's run equals a stable sort of the exact d²."""
    rng = np.random.default_rng(6)
    s = rng.integers(-3, 4, size=(300, 4)).astype(np.float32)
    r = rng.integers(-3, 4, size=(40, 4)).astype(np.float32)
    d2 = ((r[:, None, :].astype(np.float64) - s[None]) ** 2).sum(-1)
    want = np.argsort(d2, axis=1, kind="stable")[:, :12]
    pd, pi = kd.distance_topk_plain(torch.from_numpy(r), torch.from_numpy(s),
                                    12, bm=BM, bn=BN)
    np.testing.assert_array_equal(pi.numpy(), want)
    np.testing.assert_array_equal(
        pd.numpy(), np.sqrt(np.take_along_axis(d2, want, 1)).astype(
            np.float32))


def test_empty_slots_and_k_past_candidates():
    """A fully masked R tile yields (+inf, -1) everywhere; k beyond the
    visited rows pads with (+inf, -1)."""
    r, s = _inputs(5, seed=3)
    mask = np.zeros((2, 3), np.int8)
    mask[0, 2] = 1                      # R tile 0 sees the 44-row tail tile
    pd, pi = kd.distance_topk_plain(torch.from_numpy(r), torch.from_numpy(s),
                                    50, visit_mask=torch.from_numpy(mask),
                                    bm=BM, bn=BN)
    assert torch.isinf(pd[BM:]).all() and (pi[BM:] == -1).all()
    assert (pi[:BM, :44] >= 256).all() and (pi[:BM, 44:] == -1).all()
    assert torch.isinf(pd[:BM, 44:]).all()


def test_ops_dispatch_runs_plain_on_cpu_without_counting():
    """A CPU tensor goes to the plain version; only a launch of the CUDA
    kernel counts."""
    r, s = _inputs(4, seed=4)
    ops.reset_launch_counts()
    d1, i1 = ops.distance_topk(torch.from_numpy(r), torch.from_numpy(s), 5)
    d2, i2 = kd.distance_topk_plain(torch.from_numpy(r), torch.from_numpy(s),
                                    5)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    assert ops.launch_counts()["distance_topk"] == 0


def test_plain_memory_steps_do_not_change_the_result(monkeypatch):
    """The plain version walks S in groups of whole tiles; the group size
    (set by its memory budget) must not change any bit."""
    r, s = _inputs(6, seed=5)
    whole = kd.distance_topk_plain(torch.from_numpy(r), torch.from_numpy(s),
                                   9, bm=BM, bn=BN)
    monkeypatch.setattr(kd, "_PLAIN_STEP_ELEMS", 1)     # one tile a step
    step = kd.distance_topk_plain(torch.from_numpy(r), torch.from_numpy(s),
                                  9, bm=BM, bn=BN)
    assert torch.equal(whole[0], step[0]) and torch.equal(whole[1], step[1])
