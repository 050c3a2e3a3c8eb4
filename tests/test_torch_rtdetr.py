"""The port's RT-DETR-L (eval, f32) against the JAX model on converted
weights: block by block and as a whole at 64 px, the NMS-free decode, the
converter's round trip and its key layout.

Both sides run plain f32 paths on the CPU (the JAX model its XLA routes:
the Pallas gates refuse these sizes), so they differ by summation order
only. Tolerance 1e-4 x max|ref| per tensor (measured: a few 1e-6). The
weights are the flax init with re-drawn BatchNorm statistics, biases and
sampling-offset kernels, so no branch is trivially zero, and with the
score heads' kernels scaled up, so the selected queries' scores are
distinct far beyond the f32 noise between the two models.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.models import pretrained
from robust_object_detection_tpu.models import rtdetr as JR
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import rtdetr as TR
from robust_object_detection_tpu_torch.ops import conv3x3 as TC
from robust_object_detection_tpu_torch.ops import deform as TD
from robust_object_detection_tpu_torch.ops import stem as TS

torch.set_num_threads(1)

IMG = 64
TOL = 1e-4
SCORE_SCALE = 1.0


def _redraw(tree, rng, path=()):
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _redraw(x, rng, path + (k,))
            continue
        x = np.asarray(x)
        if k == "var":
            x = 1 + rng.rand(*x.shape) * 0.5
        elif k == "mean":
            x = rng.randn(*x.shape) * 0.1
        elif k == "bias":
            x = x + rng.randn(*x.shape) * 0.05
        elif k == "scale":
            x = 1 + rng.randn(*x.shape) * 0.1
        elif k == "kernel" and "sampling_offsets" in path:
            x = rng.randn(*x.shape) * 0.02
        elif k == "kernel" and path[-1].startswith(("enc_score",
                                                    "dec_score")):
            x = x * SCORE_SCALE
        out[k] = np.asarray(x, np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    jmodel = JR.create(6)
    v = jax.device_get(JR.init_variables(jmodel, jax.random.key(0), IMG))
    v = _redraw(v, np.random.RandomState(0))
    tmodel = TR.RTDETR(TR.RtDetrConfig(6)).eval()
    tmodel.load_state_dict(convert.rtdetr_from_jax_variables(
        v["params"], v["batch_stats"]), strict=True)
    return jmodel, v, tmodel


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(out - ref).max() <= tol * scale, (
        np.abs(out - ref).max(), scale)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _sub(v, *path):
    p, s = v["params"], v["batch_stats"]
    for k in path:
        p, s = p[k], s.get(k, {})
    return {"params": p, "batch_stats": s}


@pytest.mark.parametrize("block,args,cin", [
    (1, (48, 128, 3), 48),                      # dense, K3-f's convs
    (3, (96, 512, 3), 128),                     # dense, plain convs
    (6, (192, 1024, 5), 1024),                  # light, shortcut
])
def test_hgblock_matches(models, block, args, cin):
    _, v, tmodel = models
    light = block >= 5
    jb = JR.HGBlock(*args, light=light, shortcut=block in (6, 7))
    name = {1: "HGBlock_0", 3: "HGBlock_1", 6: "HGBlock_3"}[block]
    x = np.random.RandomState(block).rand(2, 8, 12, cin).astype(np.float32)
    ref = jb.apply(_sub(v, "HGNetV2L_0", name), jnp.asarray(x), False)
    before = TC.conv3x3.launches
    with torch.no_grad():
        out = tmodel.model[block](_nchw(x))
    assert TC.conv3x3.launches == before
    assert tmodel.model[block].m[0].hand_kernel == (block == 1) \
        if not light else True
    _close(_nhwc(out), ref)


def test_aifi_matches_on_a_nonsquare_map(models):
    _, v, tmodel = models
    x = np.random.RandomState(1).randn(2, 3, 5, 256).astype(np.float32)
    ref = JR.AIFI(256, 8, 1024).apply(
        {"params": v["params"]["encoder"]["aifi"]}, jnp.asarray(x), False)
    with torch.no_grad():
        out = tmodel.model[11](_nchw(x))
    _close(_nhwc(out), ref)
    np.testing.assert_array_equal(TR.sincos_pos_embed_2d(3, 5, 256),
                                  JR.sincos_pos_embed_2d(3, 5, 256))


def test_repc3_matches(models):
    _, v, tmodel = models
    x = np.random.RandomState(2).randn(2, 6, 6, 512).astype(np.float32)
    ref = JR.RepC3(256).apply(_sub(v, "encoder", "fpn0"), jnp.asarray(x),
                              False)
    with torch.no_grad():
        out = tmodel.model[16](_nchw(x))
    _close(_nhwc(out), ref)


def test_hybrid_encoder_matches(models):
    jmodel, v, tmodel = models
    rng = np.random.RandomState(3)
    feats = [rng.rand(1, 8 >> i, 8 >> i, c).astype(np.float32)
             for i, c in enumerate((512, 1024, 2048))]
    ref = JR.HybridEncoder(jmodel.cfg).apply(
        _sub(v, "encoder"), [jnp.asarray(f) for f in feats], False)
    with torch.no_grad():
        out = tmodel.encoder([_nchw(f) for f in feats])
    for o, r in zip(out, ref):
        _close(_nhwc(o), r)


def test_decoder_layer_matches(models):
    jmodel, v, tmodel = models
    rng = np.random.RandomState(4)
    b, q, c = 2, 9, 256
    levels = [rng.randn(b, h, w, c).astype(np.float32)
              for h, w in ((6, 10), (3, 5), (2, 3))]
    query = rng.randn(b, q, c).astype(np.float32)
    pos = rng.randn(b, q, c).astype(np.float32)
    ref_boxes = rng.uniform(0.1, 0.9, (b, q, 4)).astype(np.float32)
    ref = JR.DecoderLayer(jmodel.cfg).apply(
        {"params": v["params"]["layer0"]}, jnp.asarray(query),
        jnp.asarray(ref_boxes), [jnp.asarray(f) for f in levels],
        jnp.asarray(pos))
    memory = torch.cat([torch.from_numpy(f).reshape(b, -1, c)
                        for f in levels], 1)
    shapes = tuple(f.shape[1:3] for f in levels)
    with torch.no_grad():
        out = tmodel.model[28].decoder.layers[0](
            torch.from_numpy(query), torch.from_numpy(ref_boxes), memory,
            shapes, torch.from_numpy(pos))
    _close(out.numpy(), ref)


def test_whole_model_and_postprocess_match(models):
    jmodel, v, tmodel = models
    x = np.random.RandomState(9).rand(2, IMG, IMG, 3).astype(np.float32)
    ref = jax.device_get(jmodel.apply(v, jnp.asarray(x), train=False))
    counters = (TS.stem_fused_inference, TC.conv3x3, TD.ms_deform_attn_slots)
    before = [f.launches for f in counters]
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    assert [f.launches for f in counters] == before     # CPU: plain versions
    assert out.keys() == ref.keys()
    assert out["logits"].shape == (6, 2, 84, 6)         # all six layers
    for k in ref:
        _close(out[k].numpy(), ref[k])
    # the selected anchors' scores are distinct far beyond the f32 noise
    # between the two models (a few 1e-6), so the query order is defined
    top = np.sort(np.asarray(ref["enc_logits"]).max(-1), -1)
    assert (np.diff(top, axis=-1) > 4e-5).all()
    # decode: the same function on the same tensors (exact classes and
    # validity), and end to end (sorted scores, robust to near-ties)
    jp = jax.device_get(JR.postprocess(ref, IMG, 50))
    same = TR.postprocess({k: torch.from_numpy(np.array(a))
                           for k, a in ref.items()}, IMG, 50)
    np.testing.assert_array_equal(same[2].numpy(), jp[2])     # classes
    np.testing.assert_array_equal(same[3].numpy(), jp[3])     # valid
    np.testing.assert_allclose(same[1].numpy(), jp[1], atol=1e-6)
    np.testing.assert_allclose(same[0].numpy(), jp[0], atol=1e-4)
    assert same[2].dtype == torch.int32 and same[0].shape == (2, 50, 4)
    tp = TR.postprocess(out, IMG, 50)
    np.testing.assert_allclose(tp[1].numpy(), jp[1], atol=1e-5)
    assert tp[3].all() and jp[3].all()


def test_predict_step_contract(models):
    from robust_object_detection_tpu_torch.train import rtdetr as TT
    _, _, tmodel = models
    x = np.random.RandomState(6).randint(0, 256, (1, IMG, IMG, 3))
    boxes, scores, classes, valid = TT.make_predict_step(IMG, max_det=30)(
        tmodel, torch.from_numpy(x.astype(np.float32)))
    assert boxes.shape == (1, 30, 4) and scores.shape == (1, 30)
    assert classes.dtype == torch.int32 and valid.dtype == torch.bool
    assert (scores[:, :-1] >= scores[:, 1:]).all()


def test_converter_round_trip(models):
    """import_rtdetr(rtdetr_from_jax_variables(v)) gives back v, leaf for
    leaf, bit for bit."""
    _, v, _ = models
    sd = convert.rtdetr_from_jax_variables(v["params"], v["batch_stats"])
    state = {k: t.numpy() for k, t in sd.items()}
    blank = jax.tree.map(np.zeros_like, v)
    back, report = pretrained.import_rtdetr(state, blank)
    assert not report.skipped
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_state_dict_keys_are_the_ultralytics_layout(models):
    from tests._torch_rtdetr import RTDETRModel
    _, _, tmodel = models
    want = RTDETRModel(6).state_dict()
    got = tmodel.state_dict()
    assert set(got) == set(want)
    differ = {k for k in want if got[k].shape != want[k].shape}
    # the reference's denoising table has one background row more
    assert differ == {"model.28.denoising_class_embed.weight"}


def test_create_needs_a_card_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TR.create(6)
    from robust_object_detection_tpu_torch.models import yolov8 as TY
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TY.create(6, "n")


def test_create_init_and_bf16_storage():
    m = TR.create(6, torch.bfloat16, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    assert not m.training
    sd = m.state_dict()
    assert sd["model.1.m.0.conv.weight"].dtype == torch.bfloat16
    assert sd["model.28.input_proj.0.0.weight"].dtype == torch.bfloat16
    assert sd["model.1.m.0.bn.weight"].dtype == torch.float32
    assert sd["model.28.enc_score_head.weight"].dtype == torch.float32
    lay = m.model[28].decoder.layers[0].cross_attn
    assert torch.all(lay.sampling_offsets.weight == 0)
    np.testing.assert_allclose(
        lay.sampling_offsets.bias.detach().numpy(),
        np.asarray(JR._offset_bias_init(8, 3, 4)(None, None)))
    w = m.model[28].enc_output[0].weight
    assert abs(w.std().item() * np.sqrt(w.shape[1]) - 1.0) < 0.1
    with torch.no_grad():
        out = m(torch.rand(1, IMG, IMG, 3))
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all()
               for t in out.values())
