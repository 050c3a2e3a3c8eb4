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
from robust_object_detection_tpu.models import yolov8 as jy
from robust_object_detection_tpu.train import detector as jdet
from robust_object_detection_tpu_torch.eval import fused_sweep as tfs
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import yolov8 as ty
from robust_object_detection_tpu_torch.train import detector as tdet

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


def test_fused_step_rejects_odd_dims_and_unet(setup):
    tpredict = setup[3]
    with pytest.raises(ValueError, match="even"):
        tfs.make_fused_step(tpredict, None, (33, 48), IMG)
    with pytest.raises(NotImplementedError):
        tfs.make_fused_step(tpredict, object(), (32, 48), IMG)


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
