"""The slice as a whole: the port's fused 4-pass sweep (corrupt ->
letterbox -> YOLOv8 -> decode -> multi-label NMS -> COCO mAP) against the
reference's, on the same weights and the same inputs.

Noise goes through the host_noise / MT19937 mode on both sides, so both
add identical noise planes. Weights: a JAX YOLOv8n (f32, 64 px canvas)
with re-drawn BN statistics, converted to the port. With the stock init
every class logit sits near -4.6 and the scores nearly tie, so the top-k
and NMS order would flip on 1e-6 differences of f32 summation order; the
class-head output convs are therefore scaled up (kernels x SCALE, biases
~N(0, 1)) so score gaps lie far above f32 noise, while scores stay below
saturation (sigmoid at 1.0 would tie too).

The same sweep with the RT-DETR-L predict step (NMS-free top-k) is held
against the reference's at the end of the file.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.data import convert as dconvert
from robust_object_detection_tpu.data import pipeline as pipe
from robust_object_detection_tpu.data import synthetic
from robust_object_detection_tpu.eval import fused_sweep as jfs
from robust_object_detection_tpu.models import rtdetr as jr
from robust_object_detection_tpu.models import unet as ju
from robust_object_detection_tpu.models import yolov8 as jy
from robust_object_detection_tpu.train import detector as jdet
from robust_object_detection_tpu.train import rtdetr as jrt
from robust_object_detection_tpu_torch.eval import fused_sweep as tfs
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import rtdetr as tr
from robust_object_detection_tpu_torch.models import unet as tu
from robust_object_detection_tpu_torch.models import yolov8 as ty
from robust_object_detection_tpu_torch.ops import corrupt as tc
from robust_object_detection_tpu_torch.ops import image as timage
from robust_object_detection_tpu_torch.train import detector as tdet
from robust_object_detection_tpu_torch.train import rtdetr as trt

from _torch_unet_vars import jax_unet, jnp_tree

torch.set_num_threads(1)

IMG = 64
KW = dict(num_candidates=64, max_det=32)
SCALE = 4.0   # class-head output kernels: logits spread ~N(0, 2)


@pytest.fixture(scope="module")
def setup():
    return _build()


def _build():
    jmodel = jy.create(6, "n")
    v = jax.device_get(jy.init_variables(jmodel, jax.random.key(0), IMG))
    rng = np.random.RandomState(0)
    params = jax.tree.map(np.array, v["params"])
    stats = jax.tree.map(
        lambda a: np.asarray(rng.rand(*a.shape) * 0.5 + 0.75, a.dtype),
        v["batch_stats"])
    for i in range(3):
        out = params["Head_0"][f"cls{i}_out"]
        out["kernel"] = out["kernel"] * SCALE
        out["bias"] = rng.randn(*out["bias"].shape).astype(np.float32)
    state = jdet.DetTrainState(params, stats, params, None, jnp.asarray(0))
    jpredict = jdet.make_predict_step(jmodel, IMG, **KW)
    tmodel = ty.YoloV8(ty.YoloConfig(6, "n")).eval()
    tmodel.load_state_dict(convert.from_jax_variables(params, stats, "n"))
    return state, jpredict, tmodel, tdet.make_predict_step(IMG, **KW)


def test_fused_step_matches_reference(setup):
    state, jpredict, tmodel, tpredict = setup
    b, h, w = 2, 32, 48
    rng = np.random.RandomState(1)
    clean = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    noise = rng.normal(0, 15, (b, h, w, 3)).astype(np.float32)
    jstep = jfs.make_fused_step(jpredict, None, (h, w), IMG, host_noise=True)
    ref = jax.device_get(jstep(state, None, jnp.asarray(clean),
                               jnp.asarray(noise)))
    tstep = tfs.make_fused_step(tpredict, None, (h, w), IMG, host_noise=True)
    out = [t.numpy() for t in tstep(tmodel, None, torch.from_numpy(clean),
                                    torch.from_numpy(noise))]
    assert out[0].shape == ref[0].shape == (4, b, KW["max_det"], 4)
    np.testing.assert_array_equal(out[3], ref[3])           # valid
    assert out[3].sum() > 0
    np.testing.assert_array_equal(out[2], ref[2])           # classes
    np.testing.assert_allclose(out[1], ref[1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out[0], ref[0], atol=1e-2, rtol=0)


def test_fused_step_rejects_odd_dims_and_unet(setup, unet_setup):
    """Odd native dims are refused; a U-Net gives 8 passes in the
    reference's order: corrupted[Clean, Noise, Blur, LowRes], then
    restored[Clean (the clean batch again), Noise, Blur, LowRes]."""
    _, _, tmodel, tpredict = setup
    tunet = unet_setup[2]
    with pytest.raises(ValueError, match="even"):
        tfs.make_fused_step(tpredict, None, (33, 48), IMG)
    with pytest.raises(ValueError, match="even"):
        tfs.make_fused_step(tpredict, tunet, (32, 47), IMG)
    b, h, w = 2, 32, 48
    rng = np.random.RandomState(3)
    clean = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3)).astype(
        np.uint8))
    noise = torch.from_numpy(rng.normal(0, 15, (b, h, w, 3)).astype(
        np.float32))
    out = tfs.make_fused_step(tpredict, tunet, (h, w), IMG,
                              host_noise=True)(tmodel, None, clean, noise)
    four = tfs.make_fused_step(tpredict, None, (h, w), IMG,
                               host_noise=True)(tmodel, None, clean, noise)
    assert out[0].shape == (8, b, KW["max_det"], 4)
    for o, f in zip(out, four):
        torch.testing.assert_close(o[:4], f, rtol=0, atol=0)
        torch.testing.assert_close(o[4], f[0], rtol=0, atol=0)
    x = clean.float()
    variants = (tc.add_noise(x, noise, 1.0),
                tc.apply_motion_blur(x), tc.apply_lowres(x))
    for p, img in enumerate(variants, start=5):
        restored = tu.apply_u8(tunet, img.to(torch.uint8)).float()
        want = tpredict(tmodel, timage.letterbox(restored, IMG)[0])
        for o, r in zip(out, want):
            torch.testing.assert_close(o[p], r, rtol=0, atol=0)


def test_run_fused_sweep_matches_reference(setup, tmp_path):
    state, jpredict, tmodel, tpredict = setup
    split = synthetic.make_det_split(tmp_path / "raw", n_images=3,
                                     size_range=((32, 33), (48, 49)))
    dconvert.convert_det_to_coco(split, tmp_path / "coco", "val")
    samples = pipe.index_coco(tmp_path / "coco", "val")
    ref = jfs.run_fused_sweep(jpredict, state, None, None, samples, IMG,
                              batch_size=2,
                              mt19937_rng=jfs.frozen_noise_rng())
    out = tfs.run_fused_sweep(tpredict, tmodel, None, None, samples, IMG,
                              batch_size=2,
                              mt19937_rng=tfs.frozen_noise_rng())
    assert out["images_evaluated"] == ref["images_evaluated"] == 3 * 4
    assert "restored" not in out
    for variant in tfs.TESTSET_VARIANTS:
        o, r = out["corrupted"][variant], ref["corrupted"][variant]
        assert o["images"] == r["images"] == 3
        for k in ("mAP50", "mAP50_95"):
            assert abs(o[k] - r[k]) <= 1e-3, (variant, k, o[k], r[k])


def test_run_fused_sweep_device_noise_and_loader(setup):
    """Device-drawn noise and an in-memory loader (how the card runs it)."""
    _, _, tmodel, tpredict = setup
    rng = np.random.RandomState(2)
    images = {i: rng.randint(0, 256, (32, 48, 3)).astype(np.uint8)
              for i in (1, 2, 3)}
    samples = [pipe.Sample(image_path=f"mem/{i}.png", image_id=i, width=48,
                           height=32,
                           boxes_xyxy=np.array([[4, 4, 20, 30]], np.float32),
                           classes=np.array([i % 6], np.int32))
               for i in images]
    out = tfs.run_fused_sweep(tpredict, tmodel, None, None, samples, IMG,
                              batch_size=2,
                              load_image=lambda s: images[s.image_id])
    assert out["images_evaluated"] == 12
    for variant in tfs.TESTSET_VARIANTS:
        assert 0.0 <= out["corrupted"][variant]["mAP50"] <= 1.0


# ── the 8-pass sweep: the restored stream ────────────────────────────────

@pytest.fixture(scope="module")
def unet_setup():
    """A narrow (8, 16, 32, 64) flax U-Net with redrawn statistics and
    biases, and the port's with the converted variables."""
    jmodel, v = jax_unet()
    tmodel = tu.create((8, 16, 32, 64), device="cpu")
    tmodel.load_state_dict(convert.unet_from_jax_variables(
        v["params"], v["batch_stats"]))
    return jmodel, jnp_tree(v), tmodel


def test_fused_step_restored_matches_reference(setup, unet_setup):
    """8 passes at 34 x 50 (the restored stream reflect-pads to 48 x 64):
    the same detections as the 4-pass test's tolerances, and the restored
    pixels within 1 LSB of the reference's u8 apply."""
    state, jpredict, tmodel, tpredict = setup
    junet, jvars, tunet = unet_setup
    b, h, w = 2, 34, 50
    rng = np.random.RandomState(4)
    clean = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    noise = rng.normal(0, 15, (b, h, w, 3)).astype(np.float32)
    jstep = jfs.make_fused_step(jpredict, junet, (h, w), IMG,
                                host_noise=True)
    ref = jax.device_get(jstep(state, jvars, jnp.asarray(clean),
                               jnp.asarray(noise)))
    tstep = tfs.make_fused_step(tpredict, tunet, (h, w), IMG,
                                host_noise=True)
    out = [t.numpy() for t in tstep(tmodel, None, torch.from_numpy(clean),
                                    torch.from_numpy(noise))]
    assert out[0].shape == ref[0].shape == (8, b, KW["max_det"], 4)
    np.testing.assert_array_equal(out[3], ref[3])           # valid
    assert out[3][4:].sum() > 0
    np.testing.assert_array_equal(out[2], ref[2])           # classes
    np.testing.assert_allclose(out[1], ref[1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out[0], ref[0], atol=1e-2, rtol=0)

    x = torch.from_numpy(clean).float()
    japply = ju.jit_apply_u8(junet)
    for img in (tc.add_noise(x, torch.from_numpy(noise), 1.0),
                tc.apply_motion_blur(x), tc.apply_lowres(x)):
        padded = timage.pad_to_multiple(img.to(torch.uint8), 16)
        assert padded.shape[1:3] == (48, 64)
        got = tu.apply_u8(tunet, padded).numpy().astype(int)
        want = np.asarray(japply(jvars, jnp.asarray(padded.numpy())))
        assert np.abs(got - want.astype(int)).max() <= 1


def test_run_fused_sweep_restored_matches_reference(setup, unet_setup,
                                                    tmp_path):
    state, jpredict, tmodel, tpredict = setup
    junet, jvars, tunet = unet_setup
    split = synthetic.make_det_split(tmp_path / "raw", n_images=3,
                                     size_range=((34, 35), (50, 51)))
    dconvert.convert_det_to_coco(split, tmp_path / "coco", "val")
    samples = pipe.index_coco(tmp_path / "coco", "val")
    ref = jfs.run_fused_sweep(jpredict, state, junet, jvars, samples, IMG,
                              batch_size=2,
                              mt19937_rng=jfs.frozen_noise_rng())
    out = tfs.run_fused_sweep(tpredict, tmodel, tunet, None, samples, IMG,
                              batch_size=2,
                              mt19937_rng=tfs.frozen_noise_rng())
    assert out["images_evaluated"] == ref["images_evaluated"] == 3 * 8
    assert tfs.STRATEGIES == jfs.STRATEGIES
    for st in tfs.STRATEGIES:
        assert out[st].keys() == ref[st].keys()
        for variant in tfs.TESTSET_VARIANTS:
            o, r = out[st][variant], ref[st][variant]
            assert o["images"] == r["images"] == 3
            for k in ("mAP50", "mAP50_95"):
                assert abs(o[k] - r[k]) <= 1e-3, (st, variant, k, o[k], r[k])
    for k in ("mAP50", "mAP50_95"):
        assert out["restored"]["Test_Clean"][k] == out["corrupted"][
            "Test_Clean"][k]


# ── the sweep with the RT-DETR-L predict step ────────────────────────────

@pytest.fixture(scope="module")
def rtdetr_setup():
    """JAX RT-DETR-L (f32, 64 px canvas) with re-drawn BN statistics and
    biases, converted to the port; both predict steps keep 40 queries."""
    jmodel = jr.create(6)
    v = jax.device_get(jr.init_variables(jmodel, jax.random.key(0), IMG))
    rng = np.random.RandomState(0)

    def redraw(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = redraw(x)
            elif k == "var":
                out[k] = (1 + rng.rand(*x.shape) * 0.5).astype(np.float32)
            elif k in ("mean", "bias"):
                out[k] = (np.asarray(x) + rng.randn(*x.shape) * 0.1).astype(
                    np.float32)
            else:
                out[k] = np.asarray(x)
        return out

    v = redraw(v)
    state = jrt.RtdetrTrainState(v["params"], v["batch_stats"], v["params"],
                                 None, jnp.asarray(0))
    tmodel = tr.RTDETR(tr.RtDetrConfig(6)).eval()
    tmodel.load_state_dict(convert.rtdetr_from_jax_variables(
        v["params"], v["batch_stats"]))
    return (state, jrt.make_predict_step(jmodel, IMG, max_det=40), tmodel,
            trt.make_predict_step(IMG, max_det=40))


def test_rtdetr_fused_step_matches_reference(rtdetr_setup):
    """Same detections per variant: NMS-free, so every query comes back
    valid; scores (sorted, hence robust to near-ties) within 1e-5, and
    where neighbouring scores are more than 1e-5 apart (the order is then
    certain) the same classes, and boxes within 1e-2 px."""
    state, jpredict, tmodel, tpredict = rtdetr_setup
    b, h, w = 2, 32, 48
    rng = np.random.RandomState(1)
    clean = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    noise = rng.normal(0, 15, (b, h, w, 3)).astype(np.float32)
    jstep = jfs.make_fused_step(jpredict, None, (h, w), IMG, host_noise=True)
    ref = jax.device_get(jstep(state, None, jnp.asarray(clean),
                               jnp.asarray(noise)))
    tstep = tfs.make_fused_step(tpredict, None, (h, w), IMG, host_noise=True)
    out = [t.numpy() for t in tstep(tmodel, None, torch.from_numpy(clean),
                                    torch.from_numpy(noise))]
    assert out[0].shape == ref[0].shape == (4, b, 40, 4)
    np.testing.assert_array_equal(out[3], ref[3])           # valid
    assert out[3].all()
    np.testing.assert_allclose(out[1], ref[1], atol=1e-5, rtol=0)
    gap = np.abs(np.diff(ref[1], axis=-1))
    sure = np.ones(ref[1].shape, bool)
    sure[..., 1:] &= gap > 1e-5
    sure[..., :-1] &= gap > 1e-5
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(out[2][sure], ref[2][sure])
    np.testing.assert_allclose(out[0][sure], ref[0][sure], atol=1e-2, rtol=0)


def test_rtdetr_run_fused_sweep_matches_reference(rtdetr_setup, tmp_path):
    state, jpredict, tmodel, tpredict = rtdetr_setup
    split = synthetic.make_det_split(tmp_path / "raw", n_images=3,
                                     size_range=((32, 33), (48, 49)))
    dconvert.convert_det_to_coco(split, tmp_path / "coco", "val")
    samples = pipe.index_coco(tmp_path / "coco", "val")
    ref = jfs.run_fused_sweep(jpredict, state, None, None, samples, IMG,
                              batch_size=2,
                              mt19937_rng=jfs.frozen_noise_rng())
    out = tfs.run_fused_sweep(tpredict, tmodel, None, None, samples, IMG,
                              batch_size=2,
                              mt19937_rng=tfs.frozen_noise_rng())
    assert out["images_evaluated"] == ref["images_evaluated"] == 3 * 4
    assert out["corrupted"].keys() == ref["corrupted"].keys()
    for variant in tfs.TESTSET_VARIANTS:
        o, r = out["corrupted"][variant], ref["corrupted"][variant]
        assert o.keys() == r.keys()                     # same mAP keys
        assert o["per_class_ap50"].keys() == r["per_class_ap50"].keys()
        assert o["images"] == r["images"] == 3
        for k in ("mAP50", "mAP50_95"):
            assert abs(o[k] - r[k]) <= 1e-3, (variant, k, o[k], r[k])
