"""The port's Faster R-CNN against the reference's, module by module, on
the same weights (carried across by ``convert.frcnn_from_jax_variables``)
and the same numpy-seeded inputs, at a small size: blocks (1, 1, 1, 1),
64-128 px canvases, small proposal budgets.

Tolerances: geometry (anchors, levels, slices) is held equal; f32 maps
(ResNet C2-C5, the pyramid, the RPN maps, RoIAlign, the box head) within
1e-5 x max|ref| (f32 sums in another order: ~1e-6 seen); proposals and
detections equal as sets after matching by box (the same boxes within
1e-3 px, the same classes, scores within 1e-4), where a near tie (two
overlapping candidates of one class whose scores differ by f32 noise) may
resolve the other way, at most twice an image: degenerate proposals
clipped to a border give such pairs.

The reference's BatchNorm statistics, scales and biases are redrawn from a
seed: its init (statistics 0 / 1, each bottleneck's last scale 0) would
make every residual branch silent and hide a swapped statistic.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.models import fpn as JFPN
from robust_object_detection_tpu.models import frcnn as JF
from robust_object_detection_tpu.models import pretrained
from robust_object_detection_tpu.models import resnet as JRES
from robust_object_detection_tpu.ops import boxes as jboxes
from robust_object_detection_tpu.ops import nms as jnms
from robust_object_detection_tpu.train import frcnn as JT
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import fpn as TFPN
from robust_object_detection_tpu_torch.models import frcnn as TF
from robust_object_detection_tpu_torch.models import resnet as TRES
from robust_object_detection_tpu_torch.ops import boxes as tboxes
from robust_object_detection_tpu_torch.ops import nms as tnms
from robust_object_detection_tpu_torch.train import frcnn as TT

torch.set_num_threads(1)

IMG = 96
SMALL = dict(blocks=(1, 1, 1, 1), pre_nms_topk=128, num_proposals=32)
MAP_TOL = 1e-5


def _redraw(v, rng):
    """BN statistics, scales and biases from `rng` (see the docstring)."""
    def walk(p, s):
        for k in p:
            if isinstance(p[k], dict):
                walk(p[k], s.get(k, {}) if s is not None else None)
            elif k == "scale":
                p[k] = (rng.rand(*p[k].shape) * 0.5 + 0.75).astype(np.float32)
            elif k == "bias":
                p[k] = (rng.randn(*p[k].shape) * 0.1).astype(np.float32)
        if s is not None and "mean" in s:
            s["mean"] = (rng.randn(*s["mean"].shape) * 0.1).astype(np.float32)
            s["var"] = (rng.rand(*s["var"].shape) * 0.5 + 0.75).astype(
                np.float32)
    walk(v["params"], v["batch_stats"])
    return v


def jax_frcnn(cfg, seed=0, size=64):
    """(flax model, variables as nested dicts of numpy arrays)."""
    model = JF.FasterRCNN(cfg)
    v = jax.device_get(jax.jit(lambda k: model.init(
        k, jnp.zeros((1, size, size, 3), jnp.float32), train=False))(
            jax.random.key(seed)))
    v = jax.tree.map(np.array, v)
    return model, _redraw(v, np.random.RandomState(seed + 1))


def port_frcnn(cfg_kwargs, v):
    tm = TF.FasterRCNN(TF.FrcnnConfig(**cfg_kwargs)).eval()
    tm.load_state_dict(convert.frcnn_from_jax_variables(
        v["params"], v["batch_stats"], tm.cfg), strict=True)
    return tm


def pair(**overrides):
    kw = dict(SMALL, **overrides)
    jm, v = jax_frcnn(JF.FrcnnConfig(**kw))
    return jm, v, port_frcnn(kw, v)


@pytest.fixture(scope="module")
def models():
    return pair()


def nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def assert_close(out, ref, tol=MAP_TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, (err, scale)


def images(b=2, h=IMG, w=IMG, seed=3):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


# ── geometry ─────────────────────────────────────────────────────────────

@pytest.mark.parametrize("size", [128, (64, 128), (96, 160), (768, 1344)])
def test_anchors_and_level_slices(size):
    np.testing.assert_array_equal(TF.anchor_boxes(size),
                                  JF.anchor_boxes(size))
    assert TF.level_slices(size) == JF.level_slices(size)
    for a, b in zip(TF._anchors_hw_major(size), JF._anchors_hw_major(size)):
        np.testing.assert_array_equal(a, b)


def test_bucket_canvas_p6_grid():
    """768x1344: P6 is 12 x 21 cells, the last level's anchors start at
    its corner and step by 64."""
    lo, hi = TF.level_slices((768, 1344))[-1]
    assert hi - lo == 12 * 21 * 3
    p6 = TF.anchor_boxes((768, 1344))[lo:hi].reshape(12, 21, 3, 4)
    centre = (p6[..., :2] + p6[..., 2:]) / 2
    np.testing.assert_array_equal(centre[..., 0, 0],
                                  np.tile(np.arange(21) * 64.0, (12, 1)))
    np.testing.assert_array_equal(centre[..., 0, 1],
                                  np.tile(np.arange(12)[:, None] * 64.0,
                                          (1, 21)))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0),
                                     JT.HEAD_DELTA_WEIGHTS])
def test_delta_codec(weights):
    rng = np.random.RandomState(0)
    anchors = (rng.rand(3, 40, 4) * 50 + [0, 0, 60, 60]).astype(np.float32)
    boxes = (rng.rand(3, 40, 4) * 50 + [5, 5, 70, 70]).astype(np.float32)
    # deltas past the log-space clip too
    deltas = (rng.randn(3, 40, 4) * 3).astype(np.float32)
    deltas[0, :5, 2:] = 9.0
    enc = TF.encode_deltas(torch.from_numpy(boxes), torch.from_numpy(anchors),
                           weights)
    assert_close(enc, JF.encode_deltas(boxes, anchors, weights))
    dec = TF.decode_deltas(torch.from_numpy(deltas),
                           torch.from_numpy(anchors), weights)
    assert_close(dec, JF.decode_deltas(deltas, anchors, weights))


def _roi_boxes(rng, b, r, h, w, past_border=False):
    xy = rng.rand(b, r, 2) * [w, h]
    wh = np.exp(rng.rand(b, r, 2) * np.log(max(h, w) * 2.0)) + 0.5
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if past_border:
        boxes[..., :2] -= 40.0
        boxes[..., 2:] += 40.0
    boxes[:, :2] = 0.0        # two zero (invalid) boxes an image
    return boxes


def test_assign_levels():
    rng = np.random.RandomState(1)
    boxes = _roi_boxes(rng, 2, 200, 600, 900)
    np.testing.assert_array_equal(
        TFPN.assign_levels(torch.from_numpy(boxes)).numpy(),
        np.asarray(JFPN.assign_levels(boxes)))


@pytest.mark.parametrize("past_border", [False, True])
@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_roi_align(past_border, hw):
    rng = np.random.RandomState(2)
    h, w = hw
    feats = [rng.randn(2, -(-h // s), -(-w // s), 8).astype(np.float32)
             for s in (4, 8, 16, 32)]
    boxes = _roi_boxes(rng, 2, 24, h, w, past_border)
    out = TFPN.roi_align(tuple(nchw(f) for f in feats),
                         torch.from_numpy(boxes))
    assert_close(out, JFPN.roi_align(tuple(feats), boxes))


# ── modules ──────────────────────────────────────────────────────────────

def test_resnet_stages(models):
    jm, v, tm = models
    x = images()
    ref = jm.apply(v, jnp.asarray(x), method=lambda m, x: m.backbone(x))
    with torch.no_grad():
        out = tm.backbone["body"](nchw(x))
    assert [o.shape[2:] for o in out] == [(24, 24), (12, 12), (6, 6), (3, 3)]
    for o, r in zip(out, ref):
        assert_close(nhwc(o), r)


@pytest.mark.parametrize("fpn_norm", [True, False])
def test_pyramid_and_rpn_maps(models, fpn_norm):
    jm, v, tm = models if fpn_norm else pair(fpn_norm=False)
    x = images(h=64, w=128)
    pyr_j, obj_j, d_j = jm.apply(v, jnp.asarray(x), method=jm.extract)
    with torch.no_grad():
        pyr_t, obj_t, d_t = tm.extract(torch.from_numpy(x))
    for o, r in zip(pyr_t, pyr_j):
        assert_close(nhwc(o), r)
    assert_close(obj_t, obj_j)
    assert_close(d_t, d_j)


def test_generate_proposals(models):
    jm, v, tm = models
    x = images()
    _, obj, deltas = jm.apply(v, jnp.asarray(x), method=jm.extract)
    pb_j, pv_j = JF.generate_proposals(obj, deltas, IMG, jm.cfg)
    pb_t, pv_t = TF.generate_proposals(torch.from_numpy(np.array(obj)),
                                       torch.from_numpy(np.array(deltas)),
                                       IMG, tm.cfg)
    assert int(pv_t.sum()) == int(np.asarray(pv_j).sum()) > 0
    # the NMS emits by score: equal boxes in the same order
    np.testing.assert_array_equal(pv_t.numpy(), np.asarray(pv_j))
    assert_close(pb_t, pb_j)


def test_box_head(models):
    jm, v, tm = models
    rng = np.random.RandomState(6)
    rois = rng.randn(2, 5, 7, 7, 256).astype(np.float32)
    s_j, d_j = jm.apply(v, None, jnp.asarray(rois),
                        method=jm.roi_forward_pooled)
    with torch.no_grad():
        s_t, d_t = tm.roi_forward_pooled(None, torch.from_numpy(rois))
    assert_close(s_t, s_j)
    assert_close(d_t, d_j)
    # and through RoIAlign on the reference's proposals
    x = images()
    pyr, obj, deltas = jm.apply(v, jnp.asarray(x), method=jm.extract)
    props, _ = JF.generate_proposals(obj, deltas, IMG, jm.cfg)
    s_j, d_j = jm.apply(v, pyr, props, method=jm.roi_forward)
    with torch.no_grad():
        pyr_t, _, _ = tm.extract(torch.from_numpy(x))
        s_t, d_t = tm.roi_forward(pyr_t, torch.from_numpy(np.array(props)))
    assert_close(s_t, s_j)
    assert_close(d_t, d_j)


def jax_predict(jm, v, size):
    state = JT.FrcnnTrainState(v["params"], v["batch_stats"], None,
                               jnp.asarray(0))
    return jax.jit(JT.make_predict_step(jm, size)), state


def _iou(a, b):
    iw = max(min(a[2], b[2]) - max(a[0], b[0]), 0.0)
    ih = max(min(a[3], b[3]) - max(a[1], b[1]), 0.0)
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - iw * ih)
    return iw * ih / union


def assert_detections_match(out, ref, score_atol=1e-4, max_ties=2):
    """Valid detections equal as sets: each port row matches a reference
    row by box (1e-3 px), class and score (score_atol). A near tie, two
    candidates of one class whose scores differ by f32 noise and whose
    boxes overlap past the NMS IoU, may resolve the other way: the rows
    left unmatched must then pair up as such (same class, scores within
    1e-5, IoU above 0.5), at most `max_ties` an image."""
    ob, os_, oc, ov = (t.numpy() for t in out)
    rb, rs, rc, rv = (np.asarray(t) for t in ref)
    assert ov.sum() == rv.sum() > 0
    for b in range(rb.shape[0]):
        o = [(ob[b][i], os_[b][i], oc[b][i]) for i in np.where(ov[b])[0]]
        r = [(rb[b][i], rs[b][i], rc[b][i]) for i in np.where(rv[b])[0]]
        left = list(range(len(r)))
        unmatched = []
        for box, score, cls in o:
            hit = [j for j in left if np.abs(r[j][0] - box).max() <= 1e-3]
            if not hit:
                unmatched.append((box, score, cls))
                continue
            j = hit[0]
            assert r[j][2] == cls and abs(r[j][1] - score) <= score_atol, (
                (box, score, cls), r[j])
            left.remove(j)
        assert len(unmatched) == len(left) <= max_ties, (unmatched, left)
        for box, score, cls in unmatched:
            tie = [j for j in left if r[j][2] == cls
                   and abs(r[j][1] - score) <= 1e-5
                   and _iou(r[j][0], box) > 0.5]
            assert tie, ((box, score, cls), [r[j] for j in left])
            left.remove(tie[0])


@pytest.mark.parametrize("size", [IMG, (64, 128)])
def test_predict_step(models, size):
    """The whole predict step on uint8 images: normalise, proposals, RoI
    heads, per-class decode, NMS. The class logits are scaled x10, so that
    scores spread (0.05-0.9) rather than sit near 1/7."""
    jm, v, _ = models
    v = jax.tree.map(np.array, v)
    head = v["params"]["box_head"]["Dense_1"]
    head["kernel"] = head["kernel"] * 10.0
    tm = port_frcnn(SMALL, v)
    h, w = JF._hw(size)
    x = np.random.RandomState(4).randint(0, 256, (2, h, w, 3), np.uint8)
    predict, state = jax_predict(jm, v, size)
    ref = predict(state, jnp.asarray(x))
    out = TT.make_predict_step(tm, size)(tm, torch.from_numpy(x))
    assert out[0].shape == (2, 100, 4) and out[2].dtype == torch.int32
    assert_detections_match(out, ref)


# ── conversion ───────────────────────────────────────────────────────────

def _random_tree(tree, rng):
    return jax.tree.map(
        lambda s: rng.randn(*s.shape).astype(np.float32), tree)


def test_converter_inverts_import_frcnn():
    """ResNet-50 tree (the layout import_frcnn maps): variables -> the
    port's state_dict -> import_frcnn -> the same variables, bit for bit;
    the state_dict loads into the port's model with strict=True."""
    cfg = JF.FrcnnConfig(num_proposals=8)
    shapes = jax.eval_shape(
        lambda k: JF.FasterRCNN(cfg).init(
            k, jnp.zeros((1, 64, 64, 3), jnp.float32), train=False),
        jax.random.key(0))
    v = _random_tree(shapes, np.random.RandomState(0))
    sd = convert.frcnn_from_jax_variables(v["params"], v["batch_stats"],
                                          TF.FrcnnConfig())
    back, report = pretrained.import_frcnn(
        {k: t.numpy() for k, t in sd.items()}, v)
    assert not report.skipped
    flat_a = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)
    TF.FasterRCNN().load_state_dict(sd, strict=True)


def test_torchvision_layout_loads():
    """The torchvision replica's state_dict (the fasterrcnn_resnet50_fpn_v2
    key layout) loads into the port with strict=True and gives the same
    pyramid, RPN maps and box head."""
    from _torch_frcnn import FasterRCNN, randomize
    ref = randomize(FasterRCNN(num_classes=7))
    tm = TF.FasterRCNN(TF.FrcnnConfig(normalize=False)).eval()
    tm.load_state_dict(ref.state_dict_torchvision(), strict=True)
    g = torch.Generator().manual_seed(7)
    x = torch.rand(1, 64, 64, 3, generator=g)
    rois = torch.randn(3, 7, 7, 256, generator=g)
    with torch.no_grad():
        pyr, objs, boxes, s_r, d_r = ref.forward_parts(
            x.permute(0, 3, 1, 2), rois.permute(0, 3, 1, 2))
        pyr_t, obj_t, d_t = tm.extract(x)
        s_t, dd_t = tm.roi_forward_pooled(None, rois[None])
    for o, r in zip(pyr_t, pyr):
        assert_close(o, r)
    assert_close(obj_t, torch.cat([o.permute(0, 2, 3, 1).reshape(1, -1)
                                   for o in objs], 1))
    assert_close(d_t, torch.cat([b.permute(0, 2, 3, 1).reshape(1, -1, 4)
                                 for b in boxes], 1))
    assert_close(s_t[0], s_r)
    assert_close(dd_t[0].reshape(3, -1), d_r)


def test_create_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TF.create(TF.FrcnnConfig(**SMALL))
    m = TF.create(TF.FrcnnConfig(**SMALL), device="cpu")
    assert not m.training
    assert sum(p.numel() for p in TF.FasterRCNN().parameters()) == 43_281_778
    # each bottleneck's last BN starts at scale 0, as flax's
    bn3 = m.backbone["body"].layer1[0].bn3.weight
    assert float(bn3.detach().abs().max()) == 0


def test_frozen_param_labels():
    for blocks in [(3, 4, 6, 3), (1, 1, 1, 1)]:
        for layers in range(6):
            assert (TRES.frozen_param_labels(blocks, layers)
                    == JRES.frozen_param_labels(blocks, layers))


# ── ops ──────────────────────────────────────────────────────────────────

@pytest.mark.parametrize("name", ["xywh_to_xyxy", "xyxy_to_xywh",
                                  "cxcywh_to_xyxy", "xyxy_to_cxcywh"])
def test_box_converters(name):
    b = (np.random.RandomState(0).rand(3, 7, 4) * 100).astype(np.float32)
    out = getattr(tboxes, name)(torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), getattr(jboxes, name)(b),
                               rtol=1e-6, atol=1e-5)


def test_clip_and_coco_iou():
    rng = np.random.RandomState(1)
    b = (rng.rand(2, 9, 4) * 140 - 20).astype(np.float32)
    np.testing.assert_array_equal(
        tboxes.clip_to_image(torch.from_numpy(b), 90, 110).numpy(),
        np.asarray(jboxes.clip_to_image(b, 90, 110)))
    a = (rng.rand(6, 4) * 50).astype(np.float32)
    g = (rng.rand(5, 4) * 50).astype(np.float32)
    crowd = np.array([0, 1, 0, 0, 1], bool)
    for c in (None, crowd):
        out = tboxes.pairwise_iou_xywh_coco(
            torch.from_numpy(a), torch.from_numpy(g),
            None if c is None else torch.from_numpy(c))
        np.testing.assert_allclose(
            out.numpy(), jboxes.pairwise_iou_xywh_coco(a, g, c),
            rtol=1e-6, atol=1e-7)


def test_single_image_nms():
    rng = np.random.RandomState(2)
    xy = rng.rand(60, 2) * 80
    boxes = np.concatenate([xy, xy + rng.rand(60, 2) * 30 + 5],
                           1).astype(np.float32)
    scores = rng.permutation(60).astype(np.float32) / 60 + 0.01
    scores[:6] = 0.0                                      # padding slots
    classes = rng.randint(0, 3, 60).astype(np.int32)
    for aware in (True, False):
        out = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(classes), 40, 0.5, aware)
        ref = jnms.nms(boxes, scores, classes, 40, 0.5, aware)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
