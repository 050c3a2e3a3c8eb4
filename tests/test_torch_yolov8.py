"""Port YOLOv8 (robust_object_detection_tpu_torch/models) against the
reference flax model on the same weights.

The JAX YOLOv8n (nc=6) is initialised at 64x64 in f32, its BatchNorm
affines and running statistics are re-drawn from a seed so every BN does
real work, and models/convert.from_jax_variables maps the variables onto
the port. At 64x64 the JAX backbone takes its XLA ConvBnAct branch; the
port runs the plain versions of its kernels (front and conv3x3) — the
same math. Tolerances: per-level logits within 1e-3 x max|ref| (f32 sums
in another order through ~60 convs, and the port folds BN1/BN2 of the
front into g*y + b), decoded boxes within 1e-2 px.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.models import pretrained
from robust_object_detection_tpu.models import yolov8 as jy
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import yolov8 as ty

torch.set_num_threads(1)

IMG = 64


def _randomise_bn(variables, seed):
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.asarray(rng.rand(*v.shape) * 0.5 + 0.75, v.dtype)
                      if p[-1].key == "scale" else
                      np.asarray(rng.randn(*v.shape) * 0.05, v.dtype)
                      if p[-1].key == "bias" and v.ndim == 1
                      and p[-2].key == "BatchNorm_0" else np.asarray(v)),
        variables["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.asarray(rng.randn(*v.shape) * 0.1, v.dtype)
                      if p[-1].key == "mean" else
                      np.asarray(rng.rand(*v.shape) * 0.5 + 0.75, v.dtype)),
        variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def models():
    jmodel = jy.create(6, "n")
    variables = _randomise_bn(
        jax.device_get(jy.init_variables(jmodel, jax.random.key(0), IMG)), 1)
    tmodel = ty.YoloV8(ty.YoloConfig(6, "n")).eval()
    tmodel.load_state_dict(convert.from_jax_variables(
        variables["params"], variables["batch_stats"], "n"), strict=True)
    return jmodel, variables, tmodel


def test_forward_and_decode_match_reference(models):
    jmodel, variables, tmodel = models
    x = np.random.RandomState(2).rand(2, IMG, IMG, 3).astype(np.float32)
    jouts = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        touts = tmodel(torch.from_numpy(x))
    for (jb, jc), (tb, tc) in zip(jouts, touts):
        for j, t in ((jb, tb), (jc, tc)):
            ref = np.asarray(j)
            out = t.permute(0, 2, 3, 1).numpy()
            assert out.shape == ref.shape
            assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()
    jboxes, jscores = jy.decode(jouts, IMG)
    tboxes, tscores = ty.decode(touts, IMG)
    np.testing.assert_allclose(tboxes.numpy(), jboxes, atol=1e-2, rtol=0)
    np.testing.assert_allclose(tscores.numpy(), jscores, atol=1e-4, rtol=0)


def test_state_dict_round_trips_through_reference_importer(models):
    """The port's state_dict, imported by the reference's Ultralytics-layout
    importer, reproduces the JAX variables exactly, every leaf covered."""
    _, variables, tmodel = models
    state = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    template = jax.tree.map(np.zeros_like, variables)
    back, report = pretrained.import_yolov8(state, template, variant="n")
    assert not report.skipped
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(back_leaves) == len(leaves)
    for path, v in leaves:
        np.testing.assert_array_equal(back_leaves[path], v,
                                      err_msg=jax.tree_util.keystr(path))


def test_anchor_points_equal_reference():
    for a, b in zip(ty.anchor_points(IMG), jy.anchor_points(IMG)):
        np.testing.assert_array_equal(a, b)


def test_create_matches_reference_init_statistics():
    """Seeded init follows the flax one: lecun-normal kernels, unit BN,
    class-logit bias -4.6."""
    m = ty.create(6, "n", device="cpu",
                  generator=torch.Generator().manual_seed(0))
    w = m.model[4].m[0].cv1.conv.weight
    fan_in = w[0].numel()
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.1
    assert torch.all(m.model[22].cv3[0][2].bias == -4.6)
    assert not m.training
    sd = m.state_dict()
    assert "model.22.dfl.conv.weight" in sd and "model.2.m.0.cv1.bn.running_var" in sd


def test_bf16_model_stores_conv_weights_cast_once():
    """A bf16 model holds its conv weights in bf16, equal to the f32
    model's weights cast, so a forward casts no weight; BN and the head's
    output convs stay f32."""
    m16 = ty.create(6, "n", device="cpu", dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(3))
    m32 = ty.create(6, "n", device="cpu",
                    generator=torch.Generator().manual_seed(3))
    sd16, sd32 = m16.state_dict(), m32.state_dict()
    for key in ("model.0.conv.weight", "model.2.m.0.cv1.conv.weight",
                "model.22.cv2.0.1.conv.weight"):
        assert sd16[key].dtype == torch.bfloat16
        assert torch.equal(sd16[key], sd32[key].to(torch.bfloat16))
    for key in ("model.0.bn.weight", "model.22.cv3.0.2.weight",
                "model.22.dfl.conv.weight"):
        assert sd16[key].dtype == torch.float32


def test_bf16_model_keeps_f32_head_outputs():
    m = ty.create(6, "n", device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        outs = m(torch.rand(1, IMG, IMG, 3))
    assert all(b.dtype == torch.float32 and c.dtype == torch.float32
               and torch.isfinite(b).all() for b, c in outs)
