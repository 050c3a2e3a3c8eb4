"""JAX (flax) YOLOv8 variables -> the port's ``state_dict``.

The port keeps the Ultralytics key layout (``model.{i}.…``), so this is the
exact inverse of the reference's ``models/pretrained.import_yolov8``: conv
kernels HWIO -> OIHW, BatchNorm ``scale/bias`` + ``batch_stats``
``mean/var`` -> ``weight/bias/running_mean/running_var``. Inputs are nested
dicts of numpy arrays (``jax.device_get`` of the flax variables), so this
module needs no jax.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from .yolov8 import REG_MAX, YoloConfig

Path_ = Tuple[str, ...]


def _c2f(t: str, f: Path_, n: int) -> List[Tuple[str, Path_]]:
    out = [(f"{t}.cv1", f + ("ConvBnAct_0",)),
           (f"{t}.cv2", f + ("ConvBnAct_1",))]
    for j in range(n):
        out += [(f"{t}.m.{j}.cv1", f + (f"Bottleneck_{j}", "ConvBnAct_0")),
                (f"{t}.m.{j}.cv2", f + (f"Bottleneck_{j}", "ConvBnAct_1"))]
    return out


def yolo_layout(variant: str) -> Tuple[List[Tuple[str, Path_]],
                                       List[Tuple[str, Path_]]]:
    """(conv+BN blocks, biased 1x1 output convs) as (torch prefix without
    ``model.``, flax module path) pairs — the table of import_yolov8."""
    cfg = YoloConfig(6, variant)
    B, N, H = ("Backbone_0",), ("Neck_0",), ("Head_0",)
    blocks = [("0", B + ("ConvBnAct_0",)), ("1", B + ("ConvBnAct_1",))]
    blocks += _c2f("2", B + ("C2f_0",), cfg.depth(3))
    blocks += [("3", B + ("ConvBnAct_2",))]
    blocks += _c2f("4", B + ("C2f_1",), cfg.depth(6))
    blocks += [("5", B + ("ConvBnAct_3",))]
    blocks += _c2f("6", B + ("C2f_2",), cfg.depth(6))
    blocks += [("7", B + ("ConvBnAct_4",))]
    blocks += _c2f("8", B + ("C2f_3",), cfg.depth(3))
    blocks += [("9.cv1", B + ("SPPF_0", "ConvBnAct_0")),
               ("9.cv2", B + ("SPPF_0", "ConvBnAct_1"))]
    blocks += _c2f("12", N + ("C2f_0",), cfg.depth(3))
    blocks += _c2f("15", N + ("C2f_1",), cfg.depth(3))
    blocks += [("16", N + ("ConvBnAct_0",))]
    blocks += _c2f("18", N + ("C2f_2",), cfg.depth(3))
    blocks += [("19", N + ("ConvBnAct_1",))]
    blocks += _c2f("21", N + ("C2f_3",), cfg.depth(3))
    outs = []
    for i in range(3):
        blocks += [(f"22.cv2.{i}.0", H + (f"box{i}_0",)),
                   (f"22.cv2.{i}.1", H + (f"box{i}_1",)),
                   (f"22.cv3.{i}.0", H + (f"cls{i}_0",)),
                   (f"22.cv3.{i}.1", H + (f"cls{i}_1",))]
        outs += [(f"22.cv2.{i}.2", H + (f"box{i}_out",)),
                 (f"22.cv3.{i}.2", H + (f"cls{i}_out",))]
    return blocks, outs


def _get(tree: Mapping, path: Path_):
    for p in path:
        tree = tree[p]
    return tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _oihw(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def from_jax_variables(params: Mapping, batch_stats: Mapping,
                       variant: str = "m") -> Dict[str, torch.Tensor]:
    """Flax YOLOv8 ``params`` / ``batch_stats`` -> the port's state_dict
    (f32 tensors on the CPU; load with ``model.load_state_dict``)."""
    blocks, outs = yolo_layout(variant)
    sd: Dict[str, torch.Tensor] = {}
    for tkey, path in blocks:
        p, s = _get(params, path), _get(batch_stats, path)
        sd[f"model.{tkey}.conv.weight"] = _oihw(p["Conv_0"]["kernel"])
        bn, st = p["BatchNorm_0"], s["BatchNorm_0"]
        sd[f"model.{tkey}.bn.weight"] = _t(bn["scale"])
        sd[f"model.{tkey}.bn.bias"] = _t(bn["bias"])
        sd[f"model.{tkey}.bn.running_mean"] = _t(st["mean"])
        sd[f"model.{tkey}.bn.running_var"] = _t(st["var"])
        sd[f"model.{tkey}.bn.num_batches_tracked"] = torch.tensor(0)
    for tkey, path in outs:
        p = _get(params, path)
        sd[f"model.{tkey}.weight"] = _oihw(p["kernel"])
        sd[f"model.{tkey}.bias"] = _t(p["bias"])
    sd["model.22.dfl.conv.weight"] = torch.arange(
        REG_MAX, dtype=torch.float32).view(1, REG_MAX, 1, 1)
    return sd
