"""HGStem (K4-f's module): the port's plain version against the
reference's Pallas kernels in interpret mode and its XLA route, and the
port's HGStem module against the flax one through the converter.

Tolerances: 3e-3 x max|ref| against the interpreted Pallas chain, the bar
of tests/test_pallas_stem.py (the kernels fold BN as g*y + b, the XLA
route normalises as (y - m) * r * sc + bi: another f32 association); 1e-4
x max|ref| where both sides are plain f32 convolutions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robust_object_detection_tpu.models import rtdetr as JR
from robust_object_detection_tpu.ops import pallas_stem as PS
from robust_object_detection_tpu_torch.models import rtdetr as TR
from robust_object_detection_tpu_torch.ops import stem as TS

torch.set_num_threads(1)

B, H, W, CM = 2, 64, 256, 32


def _data(seed=0, h=H, w=W):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, h, w, 3).astype(np.float32)
    params = [
        rng.randn(3, 3, 3, CM) * 0.2, rng.rand(CM) + 0.5, rng.randn(CM) * 0.1,
        rng.randn(2, 2, CM, CM // 2) * 0.2, rng.rand(CM // 2) + 0.5,
        rng.randn(CM // 2) * 0.1,
        rng.randn(2, 2, CM // 2, CM) * 0.2, rng.rand(CM) + 0.5,
        rng.randn(CM) * 0.1, rng.randn(3, 3, 2 * CM, CM) * 0.1]
    params = [p.astype(np.float32) for p in params]
    sizes = (CM, CM // 2, CM, CM)
    means = [(rng.randn(c) * 0.1).astype(np.float32) for c in sizes]
    variances = [(rng.rand(c) + 0.5).astype(np.float32) for c in sizes]
    return x, params, means, variances


def _torch_stem(x, params, means, variances):
    t = torch.from_numpy
    return TS.stem_fused_inference(
        t(x), *(t(p) for p in params), [t(m) for m in means],
        [t(v) for v in variances]).numpy()


def test_plain_stem_matches_interpreted_pallas(monkeypatch):
    monkeypatch.setattr(PS, "_INTERPRET", True)
    x, params, means, variances = _data()
    ref = np.asarray(PS.stem_fused_inference(
        jnp.asarray(x), *(jnp.asarray(p) for p in params),
        tuple(jnp.asarray(m) for m in means),
        tuple(jnp.asarray(v) for v in variances), dtype=jnp.float32))
    before = TS.stem_fused_inference.launches
    out = _torch_stem(x, params, means, variances)
    assert TS.stem_fused_inference.launches == before   # CPU: plain version
    assert out.shape == ref.shape == (B, H // 4, W // 4, CM)
    assert np.abs(out - ref).max() < 3e-3 * np.abs(ref).max()


@pytest.mark.parametrize("hw", [(64, 256), (36, 52)])
def test_hgstem_module_matches_flax(hw):
    """The port's HGStem on converted weights against flax HGStem's XLA
    route (sizes the Pallas gate refuses), one of them with H != W and
    neither a multiple of 16."""
    h, w = hw
    rng = np.random.RandomState(1)
    x = rng.rand(B, h, w, 3).astype(np.float32)
    mod = JR.HGStem(CM, 48)
    v = jax.device_get(mod.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                False))
    stats = jax.tree.map(np.array, v["batch_stats"])
    for bn in stats.values():
        st = bn["BatchNorm_0"]
        st["mean"] = (rng.randn(*st["mean"].shape) * 0.1).astype(np.float32)
        st["var"] = (rng.rand(*st["var"].shape) * 0.5 + 0.75).astype(
            np.float32)
    params = jax.tree.map(
        lambda a: np.asarray(a + rng.randn(*a.shape) * 0.05, a.dtype),
        v["params"])
    ref = np.asarray(mod.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), False))
    tmod = TR.HGStem(CM, 48).eval()
    from robust_object_detection_tpu_torch.models import convert
    sd = {}
    for name, scope in (("stem1", ("Conv_0",)), ("stem2a", ()),
                        ("stem2b", ()), ("stem3", ("Conv_0",)),
                        ("stem4", ("Conv_0",))):
        convert._conv_bn(sd, name, params, stats, (name,), conv_scope=scope)
    tmod.load_state_dict({k[len("model."):]: t for k, t in sd.items()})
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    out = out.permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (B, h // 4, w // 4, 48)
    assert np.abs(ref).max() > 0.1
    assert np.abs(out - ref).max() < 1e-4 * np.abs(ref).max()


def test_plain_stem_rounds_where_the_kernel_does():
    """bf16: intermediates are stored in bf16, BN + ReLU run in f32; the
    result stays within 2e-2 x max|ref| of the f32 chain on the same bf16
    inputs and is bf16."""
    x, params, means, variances = _data(2, 16, 24)
    t = torch.from_numpy
    xb = t(x).bfloat16()
    pb = [t(p).bfloat16() if p.ndim == 4 else t(p) for p in params]
    ms, vs = [t(m) for m in means], [t(v) for v in variances]
    out = TS.stem_fused_inference(xb, *pb, ms, vs)
    ref = TS.stem_reference(xb.float(), *(p.float() for p in pb), ms, vs)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_stem_refuses_bad_inputs():
    x, params, means, variances = _data(3, 16, 24)
    t = torch.from_numpy
    p = [t(a) for a in params]
    ms, vs = [t(m) for m in means], [t(v) for v in variances]
    with pytest.raises(ValueError, match="multiples of 4"):
        TS.stem_fused_inference(t(x)[:, :14], *p, ms, vs)
    with pytest.raises(ValueError, match="dtype"):
        TS.stem_fused_inference(t(x).half(), *p, ms, vs)
    with pytest.raises(ValueError, match="contiguous"):
        TS.stem_fused_inference(t(x)[:, :, ::2], *p, ms, vs)
    with pytest.raises(ValueError, match="HWIO"):
        TS.stem_fused_inference(t(x), p[0], p[1], p[2], p[6], *p[4:], ms, vs)
    # train mode is ported: batch statistics, running statistics updated
    stem = TR.HGStem(CM, 48).train()
    rv = stem.stem2a.bn.running_var.clone()
    out = stem(t(x))
    assert out.shape == (x.shape[0], 48, x.shape[1] // 4, x.shape[2] // 4)
    assert not torch.equal(rv, stem.stem2a.bn.running_var)
