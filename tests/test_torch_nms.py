"""Port NMS (robust_object_detection_tpu_torch/ops/nms.py) against the
reference JAX ops/nms.py on the same random boxes and distinct scores:
identical valid masks, picked classes and scores; boxes within 1e-4 (they
are gathered, not recomputed, on both sides)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robust_object_detection_tpu.ops import nms as jn
from robust_object_detection_tpu_torch.ops import nms as tn

import _torch_nms_cases as cases

torch.set_num_threads(1)


def _boxes(rng, b, n, extent=200.0):
    xy = rng.rand(b, n, 2).astype(np.float32) * extent
    wh = (rng.rand(b, n, 2).astype(np.float32) * 40 + 4)
    return np.concatenate([xy, xy + wh], -1)


def _distinct_scores(rng, shape):
    # a permutation of evenly spaced values: every gap is far above f32 noise
    s = (np.arange(np.prod(shape)) + 1) / (np.prod(shape) + 1)
    return rng.permutation(s).reshape(shape).astype(np.float32)


def _compare(out, ref):
    ob, os_, oc, ov = (t.numpy() for t in out)
    rb, rs, rc, rv = (np.asarray(t) for t in ref)
    np.testing.assert_array_equal(ov, rv)
    np.testing.assert_array_equal(oc, rc)
    np.testing.assert_array_equal(os_, rs)
    np.testing.assert_allclose(ob, rb, atol=1e-4, rtol=0)
    assert ov.sum() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_multilabel_nms_matches_reference(seed):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, 2, 120)
    scores = _distinct_scores(rng, (2, 120, 6))
    scores[scores < 0.3] = 0.0005           # below the score threshold
    kw = dict(num_candidates=300, max_outputs=50, iou_thresh=0.5,
              score_thresh=0.001)
    ref = jn.multilabel_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    out = tn.multilabel_nms(torch.from_numpy(boxes),
                            torch.from_numpy(scores), **kw)
    _compare(out, ref)


@pytest.mark.parametrize("class_aware", [True, False])
def test_batched_nms_matches_reference(class_aware):
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 3, 150, extent=120.0)
    scores = _distinct_scores(rng, (3, 150))
    classes = rng.randint(0, 6, (3, 150)).astype(np.int32)
    kw = dict(num_candidates=100, max_outputs=40, iou_thresh=0.6,
              score_thresh=0.05, class_aware=class_aware)
    ref = jn.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                         jnp.asarray(classes), **kw)
    out = tn.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(classes), **kw)
    _compare(out, ref)


def test_nms_fewer_candidates_than_outputs():
    """All live boxes picked, the rest of the slots invalid and zeroed."""
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, 1, 8, extent=1000.0)
    scores = _distinct_scores(rng, (1, 8))
    ob, os_, oc, ov = tn.batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.zeros(1, 8, dtype=torch.int32), num_candidates=8,
        max_outputs=12, iou_thresh=0.99, score_thresh=0.0)
    assert ov.sum() == 8 and not ov[0, 8:].any()
    assert torch.all(oc[0, 8:] == -1) and torch.all(ob[0, 8:] == 0)
    assert torch.all(os_[0, :8][:-1] >= os_[0, :8][1:])


# ---- the CUDA walk's algorithm, emulated ---------------------------------
# csrc/nms.cu replaces the loop on the card by one walk over the sorted
# candidates, a chunk at a time. _walk below is that walk in numpy, step for
# step (each op rounds to the boxes' type; numpy does not contract into an
# FMA), with the chunk as a parameter; it must equal the loop slot for slot.

def _suppresses(kb, ka, cb, ca, thr):
    """(n_kept, n_cand) bool: does kept box i suppress candidate j? The
    loop's IoU, as the kernel computes it (kept box in the picked role)."""
    t = kb.dtype.type
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        iw = np.maximum(np.minimum(kb[:, None, 2], cb[None, :, 2])
                        - np.maximum(kb[:, None, 0], cb[None, :, 0]), t(0))
        ih = np.maximum(np.minimum(kb[:, None, 3], cb[None, :, 3])
                        - np.maximum(kb[:, None, 1], cb[None, :, 1]), t(0))
        inter = iw * ih
        den = np.maximum((ka[:, None] + ca[None, :]) - inter, t(1e-9))
        over = (inter / den) > t(thr)
    if t(thr) >= 0:      # the kernel skips the division where inter <= 0
        over &= inter > 0
    return over


def _walk(boxes, scores, classes, max_outputs, iou_thresh, class_aware,
          chunk):
    """The kernel's chunked walk: (idx (B, P) int64, sval (B, P), walked
    (B,) int32) from sorted candidates."""
    boxes, scores = boxes.numpy(), scores.numpy()
    b_n, k_n = scores.shape
    p = max_outputs
    idx = np.zeros((b_n, p), np.int64)
    sval = np.full((b_n, p), -1, scores.dtype)
    walked = np.full(b_n, k_n, np.int32)
    for b in range(b_n):
        bx = boxes[b].copy()
        if class_aware:
            off = (classes[b].numpy().astype(np.float32)
                   * np.float32(8192.0)).astype(bx.dtype)
            bx = bx + off[:, None]
        area = (bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1])
        kept = []
        for base in range(0, k_n, chunk):
            end = min(k_n, base + chunk)
            dead = ~(scores[b, base:end] > 0)
            stop = base + int(np.argmax(dead)) if dead.any() else end
            cand = np.arange(base, stop)
            if kept and len(cand):
                cand = cand[~_suppresses(bx[kept], area[kept], bx[cand],
                                         area[cand], iou_thresh).any(0)]
            mask = _suppresses(bx[cand], area[cand], bx[cand], area[cand],
                               iou_thresh)
            mine, done = [], False
            for j in range(len(cand)):
                if not any(mask[i, j] for i in mine):
                    mine.append(j)
                    if len(kept) + len(mine) == p:
                        done = True
                        break
            for j in mine:
                idx[b, len(kept)] = cand[j]
                sval[b, len(kept)] = scores[b, cand[j]]
                kept.append(int(cand[j]))
            if done:
                walked[b] = kept[-1] + 1
                break
            if stop < end:
                walked[b] = stop
                break
    return torch.from_numpy(idx), torch.from_numpy(sval), \
        torch.from_numpy(walked)


def _sorted(boxes, scores, classes):
    """Candidates in the order topk(sorted=True) leaves them: by descending
    score, ties in any order (here: by position)."""
    s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return (torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)), s,
            torch.gather(classes, 1, order))


def _hold_walk(boxes, scores, classes, p, thr, aware, chunk):
    """The emulated walk equals the loop slot for slot, and its walk
    lengths equal walk_lengths' reading of the loop's picks; returns the
    loop's (idx, sval)."""
    idx, sval = tn._greedy_loop(boxes, scores, classes, p, thr, aware)
    widx, wsval, walked = _walk(boxes, scores, classes, p, thr, aware, chunk)
    assert torch.equal(widx, idx)
    assert torch.equal(wsval, sval)
    assert torch.equal(walked, tn.walk_lengths(idx, sval, scores))
    stats = torch.zeros(scores.shape[0], dtype=torch.int32)
    out = tn._nms_core(boxes, scores, classes, p, thr, aware, stats)
    assert torch.equal(stats, walked)
    assert torch.equal(out[3], sval > 0)
    return idx, sval


def _crowd(rng, b, k, extent, size, n_classes, dtype=np.float32):
    xy = rng.rand(b, k, 2) * extent
    wh = rng.rand(b, k, 2) * size + 1.0
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(dtype))
    classes = torch.from_numpy(rng.randint(0, n_classes, (b, k))
                               .astype(np.int32))
    return boxes, classes


CHUNKS = [32, 64, 512]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("aware", [True, False])
def test_walk_equals_loop_on_exact_ties(chunk, aware):
    """Few distinct scores: long runs of exactly equal scores, crowded
    boxes, picks that end mid-chunk."""
    rng = np.random.RandomState(10)
    boxes, classes = _crowd(rng, 3, 300, 60.0, 30.0, 3)
    scores = torch.from_numpy(rng.choice(
        np.float32([0.9, 0.5, 0.25, 0.125]), (3, 300)))
    idx, sval = _hold_walk(*_sorted(boxes, scores, classes), 40, 0.45,
                           aware, chunk)
    assert (sval > 0).sum() > 40


def _ulp_case(n=400):
    """n images of two boxes: the first (higher score) and one whose right
    edge steps by an ulp of x, so that its f32 IoU with the first, as the
    loop computes it, falls on the ulps around 0.7 (~1.3 ulps a step).
    Returns boxes (n, 2, 4), scores (n, 2) and each image's IoU."""
    first = np.float32([10.0, 20.0, 110.0, 220.0])
    bx = np.repeat(np.repeat(first[None, None], 2, 1), n, 0).copy()
    bx[:, 1, 2] = np.float32(80.0) + np.arange(n, dtype=np.float32) \
        * np.float32(2 ** -17)
    a, c = bx[:, 0], bx[:, 1]
    ka = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ca = (c[:, 2] - c[:, 0]) * (c[:, 3] - c[:, 1])
    inter = ((np.minimum(a[:, 2], c[:, 2]) - np.maximum(a[:, 0], c[:, 0]))
             * (np.minimum(a[:, 3], c[:, 3]) - np.maximum(a[:, 1], c[:, 1])))
    iou = inter / ((ka + ca) - inter)
    scores = np.repeat(np.float32([[0.9, 0.8]]), n, 0)
    return torch.from_numpy(bx), torch.from_numpy(scores), iou


@pytest.mark.parametrize("kind", ["grid", "fractional"])
@pytest.mark.parametrize("side", ["equal", "ulp_below", "ulp_above",
                                  "rounds_up"])
def test_walk_equals_loop_one_ulp_from_the_threshold(kind, side):
    """thr equal to some images' f32 IoU (not suppressed: the test is >),
    one ulp below it (suppressed) and one ulp above it; and a double thr
    that f32 rounds up onto an IoU (f32's compare keeps those, a double
    compare would not). grid: one box and edges an ulp of x apart;
    fractional: boxes whose products and sums round (an FMA in the IoU
    would move some by an ulp), thr at their densest IoU."""
    up = lambda v: np.nextafter(v, np.float32(np.inf))          # noqa: E731
    down = lambda v: np.nextafter(v, np.float32(-np.inf))       # noqa: E731
    if kind == "grid":
        boxes, scores, iou = _ulp_case()
        v = next(v for v in np.unique(iou)[1:-1]
                 if (iou == up(v)).any() and (iou == down(v)).any())
    else:
        boxes, scores, iou = cases.ulp_pairs(2048, seed=1)
        v = np.float32(cases.densest_iou(iou))
    thr = {"equal": float(v), "ulp_below": float(down(v)),
           "ulp_above": float(up(v)),
           "rounds_up": (float(v) + float(down(v))) / 2 + 1e-12}[side]
    assert float(np.float32(thr)) == (float(down(v)) if side == "ulp_below"
                                      else float(up(v)) if side == "ulp_above"
                                      else float(v))
    classes = torch.zeros(boxes.shape[:2], dtype=torch.int32)
    idx, sval = _hold_walk(boxes, scores, classes, 2, thr, False, 32)
    kept = (sval[:, 1] > 0).numpy()
    assert np.array_equal(kept, ~(iou > np.float32(thr)))
    assert kept[iou == v].all() == (side != "ulp_below")
    assert kept[iou == v].any() == (side != "ulp_below")
    assert kept.any() and not kept.all()


@pytest.mark.parametrize("chunk", CHUNKS)
def test_walk_equals_loop_where_class_offsets_round_the_area(chunk):
    """Fractional boxes of high class ids: x + class * 8192 drops low bits,
    so the area from the offset coordinates differs from the raw one."""
    rng = np.random.RandomState(12)
    boxes, _ = _crowd(rng, 2, 400, 40.0, 25.0, 1)
    boxes = boxes + torch.from_numpy(rng.rand(2, 400, 4).astype(np.float32))
    classes = torch.from_numpy(rng.randint(60, 80, (2, 400)).astype(np.int32))
    scores = torch.from_numpy(rng.rand(2, 400).astype(np.float32))
    off = classes.float()[..., None] * 8192.0
    nb = boxes + off
    raw = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    shifted = (nb[..., 2] - nb[..., 0]) * (nb[..., 3] - nb[..., 1])
    assert (raw != shifted).float().mean() > 0.5
    _hold_walk(*_sorted(boxes, scores, classes), 120, 0.5, True, chunk)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", ["k_below_p", "all_dead", "one_box",
                                  "float64", "int64_classes",
                                  "negative_threshold"])
def test_walk_equals_loop_at_the_edges(chunk, case):
    """K < P; every score <= 0; every candidate suppressed by the first
    pick; float64 boxes and scores (Faster R-CNN's float64 step); int64
    classes; a negative threshold (every pair tested, the division too)."""
    rng = np.random.RandomState(13)
    k, p, thr, dtype = 70, 100, 0.6, np.float32
    if case == "float64":
        dtype = np.float64
    boxes, classes = _crowd(rng, 2, k, 80.0, 30.0, 4, dtype)
    scores = torch.from_numpy(rng.rand(2, k).astype(dtype))
    if case == "all_dead":
        scores = -torch.from_numpy(rng.rand(2, k).astype(dtype))
        scores[:, :5] = 0.0
    if case == "one_box":
        boxes = boxes[:, :1].expand(-1, k, -1).contiguous()
        classes = torch.zeros_like(classes)
    if case == "int64_classes":
        classes = classes.long()
    if case == "negative_threshold":
        thr, p = -0.5, 20
    if case in ("k_below_p", "float64", "int64_classes", "one_box",
                "all_dead"):
        p = 100
    idx, sval = _hold_walk(*_sorted(boxes, scores, classes), p, thr, True,
                           chunk)
    n = (sval > 0).sum(1)
    if case == "all_dead":
        assert n.sum() == 0 and (idx == 0).all() and (sval == -1).all()
    if case == "one_box":
        assert (n == 1).all()
    if case == "k_below_p":
        assert (n <= k).all() and (sval[:, k:] == -1).all()


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("p", [31, 32, 33, 64, 65])
def test_walk_equals_loop_at_chunk_edges(chunk, p):
    """Picks that land on, before and after a chunk's last slot; walks that
    cross chunks with suppressions across the edge; K one over a multiple
    of the chunk; the first score <= 0 at a chunk's first slot."""
    rng = np.random.RandomState(14)
    k = 3 * chunk + 1
    boxes, classes = _crowd(rng, 3, k, 300.0, 25.0, 2)
    scores = torch.from_numpy(rng.rand(3, k).astype(np.float32) + 0.01)
    b, s, c = _sorted(boxes, scores, classes)
    s[1, 2 * chunk:] = 0.0
    s[2, chunk:] = -1.0
    _hold_walk(b, s, c, p, 0.3, True, chunk)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_sorts_unsorted_input_as_the_loop_picks(seed):
    """nms() sorts its candidates (stable, scores <= 0 as -1) and gives the
    loop's answer on them as given: ties, zeros, negatives and NaNs."""
    rng = np.random.RandomState(20 + seed)
    boxes, classes = _crowd(rng, 1, 200, 70.0, 30.0, 3)
    scores = torch.from_numpy(rng.choice(
        np.float32([0.8, 0.6, 0.3, 0.0, -0.2, np.nan]), (1, 200)))
    out = tn.nms(boxes[0], scores[0], classes[0], max_outputs=60,
                 iou_thresh=0.5)
    idx, sval = tn._greedy_loop(boxes, scores, classes, 60, 0.5, True)
    valid = sval[0] > 0
    assert torch.equal(out[3], valid)
    assert torch.equal(out[1], torch.where(valid, sval[0], 0.0))
    assert torch.equal(out[2], torch.where(valid, classes[0, idx[0]], -1))
    assert torch.equal(out[0], torch.where(valid[:, None], boxes[0, idx[0]],
                                           0.0))
    assert valid.sum() > 5


@pytest.mark.parametrize("k,p,chunk,kp_smem", [
    (30000, 300, 512, 300), (4096, 512, 512, 512), (2048, 100, 512, 100),
    (70, 100, 96, 70), (1, 1, 32, 1), (20000, 20000, 512, 0)])
def test_nms_plan(k, p, chunk, kp_smem):
    """The walk's chunk and where its kept boxes live; the shared bytes
    within the card's opt-in limit, and the spill sized per image."""
    from robust_object_detection_tpu_torch import kernels
    plan = kernels.nms_plan(4, k, p)
    assert plan["threads"] == chunk and plan["kp_smem"] == kp_smem
    assert plan["smem"] <= kernels.NMS_SMEM_LIMIT
    assert plan["spill"] == (0 if kp_smem else
                             4 * kernels.nms_spill_rows(min(k, p)) * 5)
    with pytest.raises(ValueError):
        kernels.nms_plan(4, 0, p)


@pytest.mark.parametrize("levels", [0, 16])
def test_walk_equals_loop_on_crowded_candidates(levels):
    """The sweep's kind of input at a small size: boxes jittered around
    objects, 6 classes, scores continuous or on 16 levels; the walk runs
    past several chunks of 512 before its 300th pick."""
    boxes, scores, classes = cases.crowd(2, 3000, 6, seed=levels,
                                         objects=10, levels=levels)
    idx, sval = _hold_walk(boxes, scores, classes, 300, 0.7, True, 512)
    walked = tn.walk_lengths(idx, sval, scores)
    assert (walked > 1024).all()
