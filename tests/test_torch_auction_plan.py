"""K6 (``csrc/auction.cu``) as redesigned for Hopper, held on the CPU:

  * a torch model of the kernel's algorithm: the column list (valid GTs
    first), the auction rounds with the `assigned` flags updated in the
    resolve pass and the open count kept from the GTs that became
    assigned, then the greedy completion in rounds of mutually best pairs
    (each free column's best free query, each free query's best free
    column, both under the strict order larger value, lower query, lower
    GT; only those whose best was taken scan again; pairs at BIG / 2 or
    more never taken). It equals the plain version (``_greedy_owner``,
    ``auction_assignment_plain``) element for element on random costs,
    costs quantised to force ties, columns that cannot be assigned, a
    column marked invalid but priced below BIG / 2, Q < M and Q > M, and a
    hypothesis sweep of small shapes;
  * the staging plan (``kernels.auction_plan``): rows staged and shared
    bytes within 227 KB at the train, capped and odd shapes, and a shape
    whose state alone does not fit refused;
  * the wrapper, through a recording stand-in for the kernel library: it
    hands the kernel ``cost`` itself (no transposed copy), in one launch a
    call, and returns a bool ``capped``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from test_torch_deform_plan import lib  # noqa: F401 (fixture)
from test_torch_front_plan import recorder  # noqa: F401 (fixture)

from robust_object_detection_tpu_torch import kernels as K
from robust_object_detection_tpu_torch.ops import assignment as AS

torch.set_num_threads(1)

BIG = AS.BIG
NEG = np.float32(-1e18)


def _beats(v, i, w, j):
    return v > w or (v == w and i < j)


def greedy_rounds_model(cost):
    """The kernel's greedy completion on one image's cost (Q, M) f32:
    (owner (Q,) int64 GT index or -1, rounds that took a pair)."""
    qn, m = cost.shape
    value = -cost
    qfree = torch.ones(qn, dtype=torch.bool)
    cfree = torch.ones(m, dtype=torch.bool)
    owner = torch.full((qn,), -1, dtype=torch.int64)
    ninf = torch.tensor(float("-inf"))

    def col_best(i):             # lowest query among the best free ones
        v, q = AS._first_max(torch.where(qfree, value[:, i], ninf), 0)
        return int(q) if v > -BIG / 2 else -1

    def row_best(q):             # lowest GT among the best free ones
        v, i = AS._first_max(torch.where(cfree, value[q], ninf), 0)
        return int(i) if v > -BIG / 2 else -1

    colq = [col_best(i) for i in range(m)]
    rowm = [row_best(q) for q in range(qn)]
    rounds = 0
    while True:
        taken = [q for q in range(qn) if qfree[q] and rowm[q] >= 0
                 and colq[rowm[q]] == q]
        if not taken:
            return owner, rounds
        for q in taken:
            owner[q] = rowm[q]
            qfree[q] = False
            cfree[rowm[q]] = False
        rounds += 1
        for i in range(m):
            if cfree[i] and colq[i] >= 0 and not qfree[colq[i]]:
                colq[i] = col_best(i)
        for q in range(qn):
            if qfree[q] and rowm[q] >= 0 and not cfree[rowm[q]]:
                rowm[q] = row_best(q)


def kernel_model(cost, valid, eps=0.005, max_rounds=150,
                 complete_greedy=True):
    """The kernel's algorithm on the CPU, one image at a time, in f32:
    (owner (B, Q) int32, capped (B,) bool, rounds (B, 2) int: auction
    rounds run, greedy rounds)."""
    b, qn, m = cost.shape
    owners, cappeds, stats = [], [], []
    eps32 = np.float32(eps)
    for img in range(b):
        c = cost[img].numpy()
        vld = valid[img].numpy()
        cols = [i for i in range(m) if vld[i]] + \
            [i for i in range(m) if not vld[i]]
        nv = int(vld.sum())
        value = -c[:, cols].T                        # (list entry, Q)
        price = np.zeros(qn, np.float32)
        owner = np.full(qn, -1)
        assigned = np.zeros(m, bool)
        n_open, rounds = nv, 0
        while n_open and rounds < max_rounds:
            bids = {}
            for i in range(nv):
                if assigned[i]:
                    continue
                net = value[i] - price
                j1 = int(np.argmax(net))
                w2 = np.max(np.delete(net, j1)) if qn > 1 else NEG
                bp = np.float32(np.float32(net[j1] + price[j1]) - w2) + eps32
                if j1 not in bids or _beats(bp, i, *bids[j1]):
                    bids[j1] = (np.float32(bp), i)
            for q, (bp, i) in bids.items():
                if bp > NEG / 2:
                    if owner[q] >= 0:
                        assigned[owner[q]] = False
                    else:
                        n_open -= 1
                    price[q], owner[q], assigned[i] = bp, i, True
            rounds += 1
        capped = n_open > 0
        greedy = 0
        out = np.array([cols[i] if i >= 0 else -1 for i in owner])
        if capped and complete_greedy:
            g_owner, greedy = greedy_rounds_model(cost[img])
            out = g_owner.numpy()
        owners.append(out)
        cappeds.append(capped)
        stats.append((rounds, greedy))
    return (torch.from_numpy(np.stack(owners)).to(torch.int32),
            torch.tensor(cappeds), stats)


def _costs(seed, b, q, m, n_valid, quantum=None, cheap_invalid=False):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 4, (b, q, m)).astype(np.float32)
    if quantum:                  # ties: costs on a grid of 1/quantum
        cost = np.round(cost * quantum) / quantum
    valid = np.zeros((b, m), bool)
    for i, n in enumerate(n_valid):
        cols = rng.permutation(m)[:n] if i % 2 else np.arange(n)
        valid[i, cols] = True
    cost = np.where(valid[:, None, :], cost, np.float32(BIG))
    if cheap_invalid:            # invalid, yet priced below BIG / 2
        cost[0, :, m - 1] = np.float32(2.5)
        valid[0, m - 1] = False
    return torch.from_numpy(cost.astype(np.float32)), torch.from_numpy(valid)


CASES = {
    # name: (B, Q, M, valid GTs per image, max_rounds, quantum, cheap)
    "converges": (3, 40, 30, [12, 30, 0], 150, None, False),
    "capped_dense": (2, 24, 24, [24, 24], 4, None, False),
    "ties": (3, 20, 20, [20, 14, 20], 3, 4, False),
    "ties_fine": (2, 30, 30, [30, 30], 16, 64, False),
    "q_less_than_m": (2, 6, 11, [11, 9], 16, None, False),
    "q_more_than_m": (2, 17, 5, [5, 4], 2, None, False),
    "all_padded": (2, 9, 6, [0, 6], 16, None, False),
    "cheap_invalid": (2, 12, 10, [10, 10], 3, None, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_rounds_equal_the_plain_greedy(name):
    b, q, m, n_valid, _, quantum, cheap = CASES[name]
    cost, _ = _costs(0, b, q, m, n_valid, quantum, cheap)
    ref = AS._greedy_owner(cost)
    for img in range(b):
        owner, rounds = greedy_rounds_model(cost[img])
        assert torch.equal(owner.to(torch.int32), ref[img]), img
        assert rounds <= (ref[img] >= 0).sum()


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_model_equals_the_plain_version(name):
    b, q, m, n_valid, rounds, quantum, cheap = CASES[name]
    cost, valid = _costs(1, b, q, m, n_valid, quantum, cheap)
    owner, capped, _ = kernel_model(cost, valid, max_rounds=rounds)
    ref_owner, ref_capped = AS.auction_assignment_plain(cost, valid,
                                                        max_rounds=rounds)
    assert torch.equal(capped, ref_capped)
    assert torch.equal(owner, ref_owner)
    raw, _, _ = kernel_model(cost, valid, max_rounds=rounds,
                             complete_greedy=False)
    assert torch.equal(raw, AS.auction_assignment_ref(cost, valid, 0.005,
                                                      rounds)[0])


def test_greedy_takes_many_pairs_a_round_at_the_capped_shape():
    """At 300 x 300 random costs the rounds are a handful, not 300
    picks."""
    cost, _ = _costs(2, 1, 300, 300, [300])
    owner, rounds = greedy_rounds_model(cost[0])
    assert torch.equal(owner.to(torch.int32), AS._greedy_owner(cost)[0])
    assert (owner >= 0).sum() == 300 and rounds < 30


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 9), st.integers(1, 9), st.integers(0, 3),
       st.sampled_from([None, 2, 8]), st.integers(0, 2 ** 31 - 1),
       st.integers(0, 4))
def test_kernel_model_sweep_of_small_shapes(q, m, b, quantum, seed,
                                            max_rounds):
    b += 1
    rng = np.random.default_rng(seed)
    n_valid = [int(rng.integers(0, m + 1)) for _ in range(b)]
    cost, valid = _costs(seed, b, q, m, n_valid, quantum,
                         cheap_invalid=bool(seed % 3 == 0) and m > 1)
    owner, capped, _ = kernel_model(cost, valid, max_rounds=max_rounds)
    ref_owner, ref_capped = AS.auction_assignment_plain(
        cost, valid, max_rounds=max_rounds)
    assert torch.equal(capped, ref_capped)
    assert torch.equal(owner, ref_owner)


@pytest.mark.parametrize("q,m,n_valid,staged", [
    (300, 300, 80, 80),       # the train step's matcher: every row staged
    (300, 300, 300, 185),     # capped: 115 rows read where they lie
    (7, 5, 3, 3),             # odd
    (428, 300, 80, 80),       # the denoising queries' width
    (1, 1, 1, 1)])
def test_staging_plan_fits_shared_memory(q, m, n_valid, staged):
    plan = K.auction_plan(q, m)
    assert plan["qs"] % 4 == 0 and q <= plan["qs"] < q + 4
    assert plan["smem"] == plan["state"] + plan["cap"] * plan["qs"] * 4
    assert plan["smem"] <= 232448 - 1024
    assert K.auction_rows_staged(plan, n_valid) == staged
    if plan["cap"] < m:       # no room for one more row
        assert plan["smem"] + plan["qs"] * 4 > K.AUCTION_SMEM_LIMIT


@pytest.mark.parametrize("q,m", [(0, 5), (5, 0), (20000, 300),
                                 (300, 40000)])
def test_staging_plan_refuses_what_does_not_fit(q, m):
    with pytest.raises(ValueError):
        K.auction_plan(q, m)


@pytest.mark.parametrize("rounds", [False, True])
def test_wrapper_hands_the_kernel_cost_in_one_launch(lib, recorder,
                                                     rounds):
    made = recorder[1]
    cost, valid = _costs(3, 2, 30, 20, [20, 7])
    before = AS.auction_assignment.launches
    stats = torch.empty((2, 2), dtype=torch.int32) if rounds else None
    owner, capped = AS._auction_cuda(cost, valid, 0.005, 16, True, stats)
    assert AS.auction_assignment.launches == before + 1
    assert list(lib.calls) == ["auction_assign"]
    args = lib.calls["auction_assign"]
    plan = K.auction_plan(30, 20)
    assert args[0] == cost.data_ptr() and args[1] == valid.data_ptr()
    assert made[args[2]] is owner and made[args[3]] is capped
    assert owner.shape == (2, 30) and owner.dtype == torch.int32
    assert capped.shape == (2,) and capped.dtype == torch.bool
    assert args[4] == (None if stats is None else stats.data_ptr())
    assert args[5:11] == (2, 30, 20, plan["qs"], plan["cap"], plan["smem"])
    assert args[11] == pytest.approx(0.005)
    assert args[12:] == (16, 1, 0)         # max_rounds, greedy, stream


@pytest.mark.parametrize("bad,match", [
    (lambda c, v: (c.double(), v), "float32 cost"),
    (lambda c, v: (c, v[:, :2]), "does not match"),
    (lambda c, v: (c[0], v), "takes cost"),
    (lambda c, v: (c, v.int()), "bool"),
])
def test_wrapper_refuses_before_any_launch(lib, bad, match):
    cost, valid = _costs(4, 2, 6, 5, [5, 2])
    before = AS.auction_assignment.launches
    with pytest.raises(ValueError, match=match):
        AS.auction_assignment(*bad(cost, valid))
    with pytest.raises(ValueError, match="max_rounds"):
        AS.auction_assignment(cost, valid, max_rounds=-1)
    with pytest.raises(ValueError, match="CUDA card"):
        AS.auction_assignment_rounds(cost, valid)
    assert AS.auction_assignment.launches == before
    assert lib.calls == {}
