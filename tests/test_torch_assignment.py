"""The port's ``ops.assignment.auction_assignment`` (K6's plain version on
the CPU) against the reference's ``auction_assignment``: on its XLA path
and, with ``A._INTERPRET`` set, through its Pallas kernel. Continuous random
costs from a numpy seed go to both sides; the assignments and the capped
flags are compared by equality (the algorithm is deterministic and every
compare is an f32 compare on the same values)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robust_object_detection_tpu.ops import assignment as A
from robust_object_detection_tpu_torch.ops import assignment as TA

torch.set_num_threads(1)

CASES = {
    # name: (B, Q, M, valid GTs per image, max_rounds)
    "normal": (4, 64, 40, [40, 12, 1, 0], 150),
    "capped_more_gts_than_queries": (2, 16, 24, [24, 20], 30),
    "capped_one_image_of_two": (2, 16, 24, [24, 3], 30),
    "round_cap_16_dense": (3, 40, 40, [40, 40, 7], 16),
    "empty_and_single_gt": (2, 8, 4, [0, 1], 150),
    "odd_sizes": (3, 7, 5, [5, 3, 0], 16),
}


def _costs(seed, b, q, m, n_valid):
    rng = np.random.RandomState(seed)
    cost = rng.randn(b, q, m).astype(np.float32) * 5
    valid = np.zeros((b, m), bool)
    for i in range(b):
        valid[i, :n_valid[i]] = True
        cost[i, :, n_valid[i]:] = A.BIG
    return cost, valid


def _port(cost, valid, **kw):
    before = TA.auction_assignment.launches
    owner, capped = TA.auction_assignment(torch.from_numpy(cost),
                                          torch.from_numpy(valid), **kw)
    assert TA.auction_assignment.launches == before      # CPU: plain version
    assert owner.dtype == torch.int32 and capped.dtype == torch.bool
    return owner.numpy(), capped.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference_xla_path(name):
    b, q, m, n_valid, rounds = CASES[name]
    cost, valid = _costs(0, b, q, m, n_valid)
    ref_owner, ref_capped = A.auction_assignment(
        jnp.asarray(cost), jnp.asarray(valid), max_rounds=rounds)
    owner, capped = _port(cost, valid, max_rounds=rounds)
    np.testing.assert_array_equal(capped, np.asarray(ref_capped))
    np.testing.assert_array_equal(owner, np.asarray(ref_owner))
    if name.startswith(("capped", "round_cap")):
        assert capped.any()                  # the greedy completion ran


@pytest.mark.parametrize("name", list(CASES))
def test_matches_interpreted_pallas_kernel(name, monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)
    b, q, m, n_valid, rounds = CASES[name]
    cost, valid = _costs(1, b, q, m, n_valid)
    ref_owner, ref_capped = A.auction_assignment(
        jnp.asarray(cost), jnp.asarray(valid), max_rounds=rounds,
        use_pallas=True)
    owner, capped = _port(cost, valid, max_rounds=rounds)
    np.testing.assert_array_equal(capped, np.asarray(ref_capped))
    np.testing.assert_array_equal(owner, np.asarray(ref_owner))


@pytest.mark.parametrize("name", ["normal", "capped_one_image_of_two"])
def test_round_loop_without_completion_matches_reference(name):
    b, q, m, n_valid, rounds = CASES[name]
    cost, valid = _costs(2, b, q, m, n_valid)
    ref_owner, ref_capped = A.auction_assignment_ref(
        jnp.asarray(cost), jnp.asarray(valid), max_rounds=rounds)
    owner, capped = TA.auction_assignment_ref(
        torch.from_numpy(cost), torch.from_numpy(valid), max_rounds=rounds)
    np.testing.assert_array_equal(owner.numpy(), np.asarray(ref_owner))
    np.testing.assert_array_equal(capped.numpy(), np.asarray(ref_capped))
    raw, _ = _port(cost, valid, max_rounds=rounds, complete_greedy=False)
    np.testing.assert_array_equal(raw, np.asarray(ref_owner))


def test_greedy_owner_matches_reference_with_ties():
    """Exact ties: both take the lowest flat (query, GT) index."""
    rng = np.random.RandomState(3)
    cost = rng.randint(0, 4, (3, 9, 6)).astype(np.float32)
    cost[1, :, 4:] = A.BIG
    ref = np.asarray(A._greedy_owner(jnp.asarray(cost), 6))
    np.testing.assert_array_equal(
        TA._greedy_owner(torch.from_numpy(cost)).numpy(), ref)


def test_assignment_is_one_to_one_and_valid():
    cost, valid = _costs(4, 2, 16, 24, [24, 20])
    owner, capped = _port(cost, valid, max_rounds=30)
    assert capped.all()
    for i, nv in enumerate([24, 20]):
        got = owner[i][owner[i] >= 0]
        assert len(set(got.tolist())) == len(got) == 16 and (got < nv).all()


def test_refuses_bad_inputs():
    cost, valid = (torch.from_numpy(a) for a in _costs(5, 1, 4, 3, [2]))
    with pytest.raises(ValueError, match="float32 cost"):
        TA.auction_assignment(cost.double(), valid)
    with pytest.raises(ValueError, match="float32 cost"):
        TA.auction_assignment(cost, valid.float())
    with pytest.raises(ValueError, match="does not match"):
        TA.auction_assignment(cost, valid[:, :2])
    with pytest.raises(ValueError, match="empty"):
        TA.auction_assignment(cost[:, :0], valid)
