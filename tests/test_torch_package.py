"""The port package: jax-free imports, lazy kernel build, CPU routing.

The import check runs in a subprocess, because this test process already
holds jax (tests/conftest.py imports it)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from robust_object_detection_tpu_torch import kernels

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "robust_object_detection_tpu_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import torch
torch.set_num_threads(1)
import robust_object_detection_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import importlib.util
spec = importlib.util.spec_from_file_location(
    "full_pipeline_synthetic_torch",
    "examples/full_pipeline_synthetic_torch.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from robust_object_detection_tpu_torch.ops.conv3x3 import conv3x3
y = conv3x3(torch.zeros(1, 4, 4, 2), torch.ones(3, 3, 2, 5))
heavy = sorted(m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cv2",
                                      "PIL", "matplotlib",
                                      "robust_object_detection_tpu"))
print(json.dumps({"modules": names, "heavy": heavy, "shape": list(y.shape),
                  "launches": conv3x3.launches}))
"""


def test_package_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["heavy"] == []
    assert out["shape"] == [1, 4, 4, 5] and out["launches"] == 0
    expected = {f"robust_object_detection_tpu_torch.{m}" for m in (
        "kernels", "core.config", "ops.image", "ops.corrupt", "ops.conv3x3",
        "ops.yolo_front", "ops.nms", "ops.fused_corrupt", "ops.boxes",
        "models.layers", "models.yolov8", "models.convert", "train.detector",
        "train.detection", "train.augment", "eval.fused_sweep",
        "eval.coco_map", "native", "data.visdrone", "data.pipeline",
        "ops.stem", "ops.deform", "models.rtdetr", "train.rtdetr",
        "ops.assignment", "core.artifacts", "core.checkpoint",
        "core.profiling", "ops.ssim", "models.unet", "train.restoration",
        "data.testsets", "data.restore", "models.resnet", "models.fpn",
        "models.frcnn", "train.frcnn", "train.validation",
        "eval.detector_eval", "cli", "data.imageio", "data.synthetic",
        "data.convert", "core.rng", "eval.parity_fixtures",
        "parallel.distributed", "parallel.mesh", "report.plots",
        "report.demo")}
    assert expected <= set(out["modules"])


def test_no_module_imports_jax():
    """No module of the port, nor the scripts that drive it, imports jax or
    anything of the reference package (a docstring may name a counterpart
    file; an import line may not name the package)."""
    files = (list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + list((ROOT / "tools").glob("profile_torch_*.py"))
             + [ROOT / "tools" / "smoke_phases.py",
                ROOT / "tools" / "tp_determinism.py",
                ROOT / "tools" / "sass_compare.py",
                ROOT / "tools" / "mma_tf32_rate.py",
                ROOT / "examples" / "full_pipeline_synthetic_torch.py"])
    assert len(files) > 20
    ref_import = re.compile(
        r"^\s*(from|import)\s+(.*\s)?robust_object_detection_tpu[.\s]", re.M)
    for p in files:
        src = p.read_text()
        for mod in ("jax", "flax", "optax"):
            assert f"import {mod}" not in src, p
            assert f"from {mod}" not in src, p
        assert not ref_import.search(src), p


_NO_PIL_NO_CV2 = r"""
import sys
sys.modules["PIL"] = None       # any import of them now raises
sys.modules["cv2"] = None
import numpy as np
from robust_object_detection_tpu_torch.data.pipeline import Sample
from robust_object_detection_tpu_torch.train import augment
samples = [Sample(None, i + 1, 32, 32, np.asarray([[2., 3., 20., 25.]],
                  np.float32), np.asarray([i % 6], np.int32))
           for i in range(4)]
load = lambda s: np.full((32, 32, 3), s.image_id * 40, np.uint8)
batches = list(augment.mosaic_batches(samples, 2, 32, max_boxes=8, seed=0,
                                      load_image=load))
print(len(batches), batches[0].images.shape)
"""


def test_host_augmentation_needs_no_pil_or_cv2():
    """The card's machine has neither PIL nor cv2: train/augment.py imports
    neither, and mosaic + affine batches come out with both unimportable,
    given in-memory images at the canvas size."""
    src = (PKG / "train" / "augment.py").read_text()
    assert not re.search(r"^\s*(from|import)\s+(PIL|cv2)\b", src, re.M)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _NO_PIL_NO_CV2], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["2", "(2,", "32,", "32,", "3)"]


def test_image_libraries_only_inside_functions():
    """cv2 and matplotlib are imported only inside the functions that draw
    boxes and text (report/demo.py) or figures (report/plots.py); PIL is
    imported nowhere (JPEG and PNG go through the port's own codecs), and
    nothing else of the port, nor its example, imports any of them."""
    allowed = {"demo.py": "cv2", "plots.py": "matplotlib"}
    files = (list(PKG.rglob("*.py"))
             + [ROOT / "examples" / "full_pipeline_synthetic_torch.py"])
    for p in files:
        src = p.read_text()
        assert not re.search(r"^(from|import)\s+(PIL|cv2|matplotlib)\b",
                             src, re.M), p
        for lib in ("PIL", "cv2", "matplotlib"):
            if re.search(rf"^\s+(from|import)\s+{lib}\b", src, re.M):
                assert allowed.get(p.name) == lib, (p, lib)


def test_kernel_sources_and_hash():
    names = [p.name for p in kernels.sources()]
    assert {"conv3x3.cu", "yolo_front.cu", "conv_tile.cuh",
            "conv3x3_wgrad.cu", "yolo_front_bwd.cu", "corrupt.cu",
            "conv_wgrad.cuh", "hgstem.cu", "ms_deform_attn.cu",
            "hgstem_bwd.cu", "auction.cu", "stamp_scatter.cu",
            "ms_deform_attn_sorted.cu", "deform_bwd.cu", "owner_scatter.cuh",
            "deform_rows.cuh", "deform_levels.cuh", "conv3x3_tc.cuh",
            "front_tc.cuh", "deform_fwd.cuh"} <= set(names)
    assert "segment_sum.cuh" not in names
    assert kernels.source_hash() == kernels.source_hash()
    for p in kernels.sources():
        if p.suffix == ".cu":
            # every kernel source names the TPU kernel it replaces
            assert "Replaces: robust_object_detection_tpu/ops/" in \
                p.read_text(), p
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc_path()


def test_dtype_codes():
    assert kernels.dtype_code(torch.float32) == kernels.DTYPE_F32
    assert kernels.dtype_code(torch.bfloat16) == kernels.DTYPE_BF16
    with pytest.raises(ValueError):
        kernels.dtype_code(torch.float16)


def test_every_c_entry_point_has_a_signature():
    """Each ``extern "C"`` function of csrc/ is bound with its argument
    types (a pointer passed without them would be cut to 32 bits)."""
    found = set()
    for p in kernels.sources():
        found |= set(re.findall(r'extern "C" int (\w+)\(', p.read_text()))
    assert found == set(kernels.SIGNATURES)
    assert {"hgstem_train_nhwc", "hgstem_bwd_nhwc", "ms_deform_attn_bwd",
            "auction_assign", "stamp_scatter",
            "ms_deform_attn_sorted_fwd"} <= found
    assert not {"ms_deform_attn_sorted_taps",
                "ms_deform_attn_sorted_dvalues"} & found


@pytest.mark.parametrize("train", [False, True])
def test_rtdetr_create_without_a_device_means_the_card(train):
    """``create()`` with no device resolves to the CUDA card, for the
    trainer's model too, and raises where there is none; it carries on on
    the CPU only when asked to."""
    from robust_object_detection_tpu_torch.models import rtdetr as TR
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TR.create(6, train=train)
    model = TR.create(6, device="cpu", train=train)
    assert model.training == train
    assert model.model[0].stem1.conv.weight.dtype == torch.float32
    assert model.model[28].input_proj[0][0].weight.dtype == torch.float32
