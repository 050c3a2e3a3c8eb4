"""JAX (flax) YOLOv8, RT-DETR, restoration U-Net and Faster R-CNN
variables -> the port's ``state_dict``.

The port keeps the Ultralytics key layout (``model.{i}.…``), so these are
the exact inverses of the reference's ``models/pretrained.import_yolov8``
and ``import_rtdetr``, and Faster R-CNN keeps torchvision's
(``fasterrcnn_resnet50_fpn_v2``), whose inverse is ``import_frcnn``: conv
kernels HWIO -> OIHW, dense kernels (in, out)
-> (out, in), BatchNorm ``scale/bias`` + ``batch_stats`` ``mean/var`` ->
``weight/bias/running_mean/running_var``, flax per-head attention kernels
-> torch's packed ``in_proj``, flax transposed-conv kernels -> torch's
flipped ``ConvTranspose2d`` weights. Inputs are nested dicts of numpy arrays
(``jax.device_get`` of the flax variables), so this module needs no jax.
"""

from __future__ import annotations

import math
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


# ── RT-DETR-L ────────────────────────────────────────────────────────────

def _conv_bn(sd, tkey: str, params: Mapping, stats: Mapping, path: Path_,
             conv_scope: Tuple[str, ...] = ("Conv_0",)) -> None:
    """ConvBnAct (kernel under Conv_0) or Conv2x2Pad (kernel at the root,
    conv_scope=()) -> ``{tkey}.conv`` + ``{tkey}.bn``."""
    p, st = _get(params, path), _get(stats, path)
    sd[f"model.{tkey}.conv.weight"] = _oihw(_get(p, conv_scope)["kernel"])
    _bn(sd, f"{tkey}.bn", p["BatchNorm_0"], st["BatchNorm_0"])


def _bn(sd, tkey: str, p: Mapping, st: Mapping) -> None:
    sd[f"model.{tkey}.weight"] = _t(p["scale"])
    sd[f"model.{tkey}.bias"] = _t(p["bias"])
    sd[f"model.{tkey}.running_mean"] = _t(st["mean"])
    sd[f"model.{tkey}.running_var"] = _t(st["var"])
    sd[f"model.{tkey}.num_batches_tracked"] = torch.tensor(0)


def _dense(sd, tkey: str, p: Mapping) -> None:
    sd[f"model.{tkey}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"model.{tkey}.bias"] = _t(p["bias"])


def _ln(sd, tkey: str, p: Mapping) -> None:
    sd[f"model.{tkey}.weight"] = _t(p["scale"])
    sd[f"model.{tkey}.bias"] = _t(p["bias"])


def _mha(sd, tkey: str, p: Mapping) -> None:
    """flax MultiHeadDotProductAttention (query/key/value kernels (c,
    heads, dh), out kernel (heads, dh, c)) -> torch's packed in_proj (3c,
    c) and out_proj (c, c); head-major on both sides."""
    c = np.asarray(p["query"]["kernel"]).shape[0]
    ws = [np.asarray(p[n]["kernel"]).reshape(c, c).T
          for n in ("query", "key", "value")]
    bs = [np.asarray(p[n]["bias"]).reshape(c)
          for n in ("query", "key", "value")]
    sd[f"model.{tkey}.in_proj_weight"] = _t(np.concatenate(ws, 0))
    sd[f"model.{tkey}.in_proj_bias"] = _t(np.concatenate(bs, 0))
    sd[f"model.{tkey}.out_proj.weight"] = _t(
        np.asarray(p["out"]["kernel"]).reshape(c, c).T)
    sd[f"model.{tkey}.out_proj.bias"] = _t(p["out"]["bias"])


def _hgblock(sd, t: str, params, stats, f: Path_, light: bool,
             n: int = 6) -> None:
    for j in range(n):
        if light:
            _conv_bn(sd, f"{t}.m.{j}.conv1", params, stats,
                     f + (f"LightConv_{j}", "ConvBnAct_0"))
            _conv_bn(sd, f"{t}.m.{j}.conv2", params, stats,
                     f + (f"LightConv_{j}", "ConvBnAct_1"))
        else:
            _conv_bn(sd, f"{t}.m.{j}", params, stats, f + (f"ConvBnAct_{j}",))
    off = 0 if light else n
    _conv_bn(sd, f"{t}.sc", params, stats, f + (f"ConvBnAct_{off}",))
    _conv_bn(sd, f"{t}.ec", params, stats, f + (f"ConvBnAct_{off + 1}",))


def _repc3(sd, t: str, params, stats, f: Path_, n: int = 3) -> None:
    _conv_bn(sd, f"{t}.cv1", params, stats, f + ("cv1",))
    _conv_bn(sd, f"{t}.cv2", params, stats, f + ("cv2",))
    for j in range(n):
        _conv_bn(sd, f"{t}.m.{j}.conv1", params, stats,
                 f + (f"m{j}", "conv1"))
        _conv_bn(sd, f"{t}.m.{j}.conv2", params, stats,
                 f + (f"m{j}", "conv2"))


def _mlp(sd, t: str, p: Mapping, n: int = 3) -> None:
    for j in range(n):
        _dense(sd, f"{t}.layers.{j}", p[f"Dense_{j}"])


def rtdetr_from_jax_variables(params: Mapping, batch_stats: Mapping
                              ) -> Dict[str, torch.Tensor]:
    """Flax RT-DETR-L ``params`` / ``batch_stats`` -> the port's
    state_dict (f32 tensors on the CPU; ``RTDETR.load_state_dict`` takes it
    strictly). The table of ``import_rtdetr``, read the other way."""
    sd: Dict[str, torch.Tensor] = {}
    P, S = params, batch_stats
    B = ("HGNetV2L_0",)
    st = B + ("HGStem_0",)
    _conv_bn(sd, "0.stem1", P, S, st + ("stem1",))
    _conv_bn(sd, "0.stem2a", P, S, st + ("stem2a",), conv_scope=())
    _conv_bn(sd, "0.stem2b", P, S, st + ("stem2b",), conv_scope=())
    _conv_bn(sd, "0.stem3", P, S, st + ("stem3",))
    _conv_bn(sd, "0.stem4", P, S, st + ("stem4",))
    for t, blk, light in (("1", 0, False), ("3", 1, False), ("5", 2, True),
                          ("6", 3, True), ("7", 4, True), ("9", 5, True)):
        _hgblock(sd, t, P, S, B + (f"HGBlock_{blk}",), light)
    for t, i in (("2", 0), ("4", 1), ("8", 2)):
        _conv_bn(sd, t, P, S, B + (f"ConvBnAct_{i}",))
    E = ("encoder",)
    for t, name in (("10", "proj2"), ("12", "lateral0"), ("14", "proj1"),
                    ("17", "lateral1"), ("19", "proj0"), ("22", "down0"),
                    ("25", "down1")):
        _conv_bn(sd, t, P, S, E + (name,))
    for t, name in (("16", "fpn0"), ("21", "fpn1"), ("24", "pan0"),
                    ("27", "pan1")):
        _repc3(sd, t, P, S, E + (name,))
    aifi = _get(P, E + ("aifi",))
    _mha(sd, "11.ma", aifi["ma"])
    _dense(sd, "11.fc1", aifi["fc1"])
    _dense(sd, "11.fc2", aifi["fc2"])
    _ln(sd, "11.norm1", aifi["norm1"])
    _ln(sd, "11.norm2", aifi["norm2"])
    D = "28"
    for i in range(3):
        sd[f"model.{D}.input_proj.{i}.0.weight"] = _oihw(
            P[f"dec_proj{i}"]["Conv_0"]["kernel"])
        _bn(sd, f"{D}.input_proj.{i}.1", P[f"dec_proj{i}"]["BatchNorm_0"],
            S[f"dec_proj{i}"]["BatchNorm_0"])
    _dense(sd, f"{D}.enc_output.0", P["enc_output"])
    _ln(sd, f"{D}.enc_output.1", P["enc_norm"])
    _dense(sd, f"{D}.enc_score_head", P["enc_score"])
    _mlp(sd, f"{D}.enc_bbox_head", P["enc_bbox"])
    sd[f"model.{D}.denoising_class_embed.weight"] = _t(
        P["dn_class_embed"]["embedding"])
    _mlp(sd, f"{D}.query_pos_head", P["query_pos"], n=2)
    li = 0
    while f"layer{li}" in P:
        t, lp = f"{D}.decoder.layers.{li}", P[f"layer{li}"]
        _mha(sd, f"{t}.self_attn", lp["self_attn"])
        for sub in ("sampling_offsets", "attention_weights", "value_proj",
                    "output_proj"):
            _dense(sd, f"{t}.cross_attn.{sub}", lp["cross_attn"][sub])
        for sub in ("norm1", "norm2", "norm3"):
            _ln(sd, f"{t}.{sub}", lp[sub])
        _dense(sd, f"{t}.linear1", lp["linear1"])
        _dense(sd, f"{t}.linear2", lp["linear2"])
        _dense(sd, f"{D}.dec_score_head.{li}", P[f"dec_score{li}"])
        _mlp(sd, f"{D}.dec_bbox_head.{li}", P[f"dec_bbox{li}"])
        li += 1
    return sd


# ── restoration U-Net ────────────────────────────────────────────────────

def conv_transpose_weight(kernel) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, in, out), applied unflipped ->
    torch ConvTranspose2d weight (in, out, kh, kw). With k = s = 2 and
    SAME padding flax computes out[2i] = x[i] K[1], out[2i+1] = x[i] K[0]
    (per axis), torch out[2i + k] = x[i] W[k]: W is K flipped in space
    with in / out in torch's order."""
    return _t(np.flip(np.asarray(kernel), (0, 1)).transpose(2, 3, 0, 1))


def unet_from_jax_variables(params: Mapping, batch_stats: Mapping
                            ) -> Dict[str, torch.Tensor]:
    """Flax RestorationUNet ``params`` / ``batch_stats`` -> the port's
    state_dict: ``ConvBlock_0..3`` -> ``enc.0..3``, ``ConvBlock_4`` ->
    ``mid``, ``ConvBlock_5..8`` -> ``dec.0..3`` (each ``Conv_{0,1}`` /
    ``BatchNorm_{0,1}`` -> ``conv{0,1}`` / ``bn{0,1}``),
    ``ConvTranspose_0..3`` -> ``up.0..3``, ``Conv_0`` -> ``out``. A model
    built with ``remat=True`` names its blocks ``CheckpointConvBlock_i``;
    both namings are read."""
    n_blocks = sum(1 for k in params if k.startswith("ConvTranspose_"))
    prefix = next((p for p in ("ConvBlock", "CheckpointConvBlock")
                   if f"{p}_0" in params), None)
    if prefix is None or n_blocks == 0:
        raise KeyError("not a flax RestorationUNet variable tree: expected "
                       "ConvBlock_i or CheckpointConvBlock_i and "
                       f"ConvTranspose_i, got {sorted(params)}")
    targets = ([f"enc.{i}" for i in range(n_blocks)] + ["mid"]
               + [f"dec.{i}" for i in range(n_blocks)])
    sd: Dict[str, torch.Tensor] = {}
    for i, tkey in enumerate(targets):
        p, st = params[f"{prefix}_{i}"], batch_stats[f"{prefix}_{i}"]
        for j in range(2):
            sd[f"{tkey}.conv{j}.weight"] = _oihw(p[f"Conv_{j}"]["kernel"])
            bn, s = p[f"BatchNorm_{j}"], st[f"BatchNorm_{j}"]
            sd[f"{tkey}.bn{j}.weight"] = _t(bn["scale"])
            sd[f"{tkey}.bn{j}.bias"] = _t(bn["bias"])
            sd[f"{tkey}.bn{j}.running_mean"] = _t(s["mean"])
            sd[f"{tkey}.bn{j}.running_var"] = _t(s["var"])
            sd[f"{tkey}.bn{j}.num_batches_tracked"] = torch.tensor(0)
    for i in range(n_blocks):
        p = params[f"ConvTranspose_{i}"]
        sd[f"up.{i}.weight"] = conv_transpose_weight(p["kernel"])
        sd[f"up.{i}.bias"] = _t(p["bias"])
    sd["out.weight"] = _oihw(params["Conv_0"]["kernel"])
    sd["out.bias"] = _t(params["Conv_0"]["bias"])
    return sd


# ── Faster R-CNN (torchvision fasterrcnn_resnet50_fpn_v2 layout) ─────────

def _tv_bn(sd, tkey: str, p: Mapping, st: Mapping) -> None:
    sd[f"{tkey}.weight"] = _t(p["scale"])
    sd[f"{tkey}.bias"] = _t(p["bias"])
    sd[f"{tkey}.running_mean"] = _t(st["mean"])
    sd[f"{tkey}.running_var"] = _t(st["var"])
    sd[f"{tkey}.num_batches_tracked"] = torch.tensor(0)


def _tv_conv(sd, tkey: str, p: Mapping, bias: bool = False) -> None:
    sd[f"{tkey}.weight"] = _oihw(p["kernel"])
    if bias:
        sd[f"{tkey}.bias"] = _t(p["bias"])


def dense_chw(kernel, chw: Tuple[int, int, int]) -> torch.Tensor:
    """flax Dense kernel over a flattened NHWC tensor, (H*W*C, out) ->
    torch Linear weight over the flattened NCHW tensor, (out, C*H*W): the
    inverse of the reference's ``pretrained._dense_chw``."""
    c, h, w = chw
    k = np.asarray(kernel).T                            # (out, H*W*C)
    return _t(k.reshape(k.shape[0], h, w, c).transpose(0, 3, 1, 2)
              .reshape(k.shape[0], -1))


def frcnn_from_jax_variables(params: Mapping, batch_stats: Mapping,
                             cfg) -> Dict[str, torch.Tensor]:
    """Flax FasterRCNN ``params`` / ``batch_stats`` (built with `cfg`, a
    models/frcnn.FrcnnConfig) -> the port's state_dict in torchvision's
    key layout, the exact inverse of the reference's
    ``pretrained.import_frcnn``: ``backbone/Conv_0``, ``BatchNorm_0`` ->
    ``backbone.body.conv1``, ``bn1``; ``BottleneckBlock_k`` ->
    ``layer{s}.{j}`` (``Conv_0..2`` / ``BatchNorm_0..2`` -> ``conv1..3`` /
    ``bn1..3``, ``Conv_3`` / ``BatchNorm_3`` -> ``downsample.0/1``);
    ``fpn/lateral{i}(_bn)``, ``post{i}(_bn)`` ->
    ``backbone.fpn.inner_blocks.{i}.0/1``, ``layer_blocks.{i}.0/1``;
    ``rpn_head/conv{0,1}``, ``obj``, ``box`` -> ``rpn.head.conv.{0,1}.0``,
    ``cls_logits``, ``bbox_pred``; ``box_head/Conv_i``, ``BatchNorm_i`` ->
    ``roi_heads.box_head.{i}.0/1``, ``Dense_0`` -> ``box_head.5`` (input
    axis HWC -> CHW), ``Dense_1``, ``Dense_2`` -> ``box_predictor.
    cls_score``, ``bbox_pred``. With ``cfg.fpn_norm`` False (the classic
    FPN) the lateral and post convs carry a bias and have no BN:
    ``inner_blocks.{i}.0`` / ``layer_blocks.{i}.0`` with ``.bias`` are
    then the port's own keys."""
    sd: Dict[str, torch.Tensor] = {}
    bp, bs = params["backbone"], batch_stats["backbone"]
    _tv_conv(sd, "backbone.body.conv1", bp["Conv_0"])
    _tv_bn(sd, "backbone.body.bn1", bp["BatchNorm_0"], bs["BatchNorm_0"])
    k = 0
    for s, n_blocks in enumerate(cfg.blocks):
        for j in range(n_blocks):
            t = f"backbone.body.layer{s + 1}.{j}"
            p, st = bp[f"BottleneckBlock_{k}"], bs[f"BottleneckBlock_{k}"]
            for c in range(3):
                _tv_conv(sd, f"{t}.conv{c + 1}", p[f"Conv_{c}"])
                _tv_bn(sd, f"{t}.bn{c + 1}", p[f"BatchNorm_{c}"],
                       st[f"BatchNorm_{c}"])
            if "Conv_3" in p:
                _tv_conv(sd, f"{t}.downsample.0", p["Conv_3"])
                _tv_bn(sd, f"{t}.downsample.1", p["BatchNorm_3"],
                       st["BatchNorm_3"])
            k += 1
    fp = params["fpn"]
    fs = batch_stats.get("fpn", {})
    for i in range(4):
        for flax_name, tv in ((f"lateral{i}", f"inner_blocks.{i}"),
                              (f"post{i}", f"layer_blocks.{i}")):
            t = f"backbone.fpn.{tv}"
            _tv_conv(sd, f"{t}.0", fp[flax_name], bias=not cfg.fpn_norm)
            if cfg.fpn_norm:
                _tv_bn(sd, f"{t}.1", fp[f"{flax_name}_bn"],
                       fs[f"{flax_name}_bn"])
    rp = params["rpn_head"]
    for i in range(2):
        _tv_conv(sd, f"rpn.head.conv.{i}.0", rp[f"conv{i}"], bias=True)
    _tv_conv(sd, "rpn.head.cls_logits", rp["obj"], bias=True)
    _tv_conv(sd, "rpn.head.bbox_pred", rp["box"], bias=True)
    hp, hs = params["box_head"], batch_stats["box_head"]
    for i in range(4):
        _tv_conv(sd, f"roi_heads.box_head.{i}.0", hp[f"Conv_{i}"])
        _tv_bn(sd, f"roi_heads.box_head.{i}.1", hp[f"BatchNorm_{i}"],
               hs[f"BatchNorm_{i}"])
    c = np.asarray(hp["Conv_3"]["kernel"]).shape[-1]
    side = math.isqrt(np.asarray(hp["Dense_0"]["kernel"]).shape[0] // c)
    sd["roi_heads.box_head.5.weight"] = dense_chw(hp["Dense_0"]["kernel"],
                                                  (c, side, side))
    sd["roi_heads.box_head.5.bias"] = _t(hp["Dense_0"]["bias"])
    for flax_name, tv in (("Dense_1", "cls_score"), ("Dense_2", "bbox_pred")):
        sd[f"roi_heads.box_predictor.{tv}.weight"] = _t(
            np.asarray(hp[flax_name]["kernel"]).T)
        sd[f"roi_heads.box_predictor.{tv}.bias"] = _t(hp[flax_name]["bias"])
    return sd
