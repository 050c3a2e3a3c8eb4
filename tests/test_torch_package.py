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
from robust_object_detection_tpu_torch.ops.conv3x3 import conv3x3
y = conv3x3(torch.zeros(1, 4, 4, 2), torch.ones(3, 3, 2, 5))
heavy = sorted(m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cv2",
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
        "ops.assignment")}
    assert expected <= set(out["modules"])


def test_no_module_imports_jax():
    """No module of the port, nor the scripts that drive it, imports jax or
    anything of the reference package (a docstring may name a counterpart
    file; an import line may not name the package)."""
    files = (list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + list((ROOT / "tools").glob("profile_torch_*.py")))
    assert len(files) > 20
    ref_import = re.compile(
        r"^\s*(from|import)\s+(.*\s)?robust_object_detection_tpu[.\s]", re.M)
    for p in files:
        src = p.read_text()
        for mod in ("jax", "flax", "optax"):
            assert f"import {mod}" not in src, p
            assert f"from {mod}" not in src, p
        assert not ref_import.search(src), p


def test_kernel_sources_and_hash():
    names = [p.name for p in kernels.sources()]
    assert {"conv3x3.cu", "yolo_front.cu", "conv_tile.cuh",
            "conv3x3_wgrad.cu", "yolo_front_bwd.cu", "corrupt.cu",
            "conv_wgrad.cuh", "hgstem.cu", "ms_deform_attn.cu",
            "hgstem_bwd.cu", "auction.cu", "stamp_scatter.cu",
            "ms_deform_attn_sorted.cu", "segment_sum.cuh",
            "deform_levels.cuh", "conv3x3_tc.cuh", "front_tc.cuh"} <= set(names)
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
            "auction_assign", "stamp_scatter_sorted",
            "ms_deform_attn_sorted_fwd", "ms_deform_attn_sorted_taps",
            "ms_deform_attn_sorted_dvalues"} <= found


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
