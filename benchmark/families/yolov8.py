"""The YOLOv8 family: how the benchmark builds the program's model, train
step and predict step for a configuration of this family, and the plain
reference beside them."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness.weights import load_into, seeded_weights
from benchmark.reference import yolov8 as ref_yolo
from benchmark.reference.sweep_ops import multilabel_nms
from benchmark.reference.train_yolo import run_steps

RTDETR_KERNELS = False     # kernel grouping: K2 is the YOLO front here
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def reference_model(config: dict, precision: str = "exact"):
    s = config["scale"]
    return ref_yolo.YoloV8(config["nc"], s["depth"], s["width"],
                           s["max_channels"], precision)


def weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        spec = ref_yolo.weight_spec(reference_model(config))
    return seeded_weights(spec, seed, device)


def eval_weights(config: dict, seed: int, device,
                 canvases: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The weights and, for every BatchNorm, running statistics: its batch
    statistics in the plain model on `canvases` (N, S, S, 3) in [0, 1],
    the kind of input the eval model is given."""
    w = weights(config, seed, device)
    model = reference_model(config).to(device)
    model.load_state_dict(w, strict=False)
    ref_yolo.calibrate(model, canvases)
    w.update({n: b.detach().clone() for n, b in model.named_buffers()
              if ".running_" in n})
    return w


def _program_model(config: dict, device, train: bool, w):
    from robust_object_detection_tpu_torch.models import yolov8 as Y

    s = config["scale"]
    variant = config["program"]["variant"]
    if Y.VARIANTS[variant] != (s["depth"], s["width"], s["max_channels"]):
        raise ValueError(f"the program's {variant!r} is "
                         f"{Y.VARIANTS[variant]}, the configuration {s}")
    dtype = DTYPES[config["precision"]["detector"]]
    with torch.device(device):
        model = Y.YoloV8(Y.YoloConfig(config["nc"], variant), dtype,
                         param_dtype=torch.float32 if train else dtype,
                         bn_dtype=dtype if train else torch.float32)
    load_into(model, w)
    return model.train(train)


def program_train(config: dict, device, w):
    """(state, step) of the program's Augmented train step."""
    from robust_object_detection_tpu_torch.core.config import \
        CorruptionConfig
    from robust_object_detection_tpu_torch.train import detector as D

    opt = config["optimizer"]
    model = _program_model(config, device, True, w)
    tx, _ = D.make_optimizer(opt["lr0"], opt["lrf"], opt["momentum"],
                             opt["weight_decay"], opt["warmup_steps"],
                             opt["total_steps"])
    state = D.init_state(model, tx)
    step = D.make_train_step(config["imgsz"],
                             CorruptionConfig(**config["corruption"]),
                             augment=True, ema_decay=opt["ema_decay"],
                             base_augment=True)
    return state, step


def params(state) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in state.model.named_parameters()
            if p.requires_grad}


def ema(state) -> Dict[str, torch.Tensor]:
    return dict(state.ema)


def first_grad(state, p0: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The first step's gradient as SGD got it, from its momentum buffers
    after one step (buffer = gradient + weight decay x weight); a leaf
    with no buffer reads 0."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            n = names[id(p)]
            buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
            out[n] = (torch.zeros_like(p) if buf is None
                      else buf - group["weight_decay"] * p0[n].to(buf.device))
    return out


def batch_stats(state, momentum: float) -> Dict[str, torch.Tensor]:
    """The first step's batch statistics of every BatchNorm, from its
    running statistics after that step (from 0 and 1: running = momentum
    x start + (1 - momentum) x batch)."""
    out = {}
    for n, b in state.model.named_buffers():
        if ".running_" in n:
            start = 1.0 if n.endswith("running_var") else 0.0
            out[n] = (b.detach().float() - momentum * start) / (1 - momentum)
    return out


def reference_train(config, w, batches, step_seed, precision="exact"):
    return run_steps(config, w, batches, step_seed, config["imgsz"],
                     precision)


def program_eval(config: dict, device, w):
    return _program_model(config, device, False, w)


def program_predict(config: dict):
    from robust_object_detection_tpu_torch.train import detector as D
    return D.make_predict_step(config["imgsz"])


def reference_forward(model, canvas: torch.Tensor):
    """The head's raw outputs on a (B, S, S, 3) canvas in [0, 255]."""
    return model(canvas / 255.0)


def reference_decode(raw, img_size: int):
    """(boxes (B, N, 4), scores (B, N, nc)) of every anchor."""
    return ref_yolo.decode(raw, img_size)


def reference_select(boxes, scores):
    """The predict step's selection: multi-label NMS (30000 candidates,
    300 outputs, IoU 0.7, score 0.001)."""
    b, n, c = scores.shape
    return multilabel_nms(boxes, scores, min(30000, n * c), 300, 0.7, 0.001)


def flops(config: dict, batch: int, train: bool) -> float:
    """FLOPs of one forward (with train, forward and backward) of the
    plain model at (batch, imgsz)."""
    with torch.device("meta"):
        model = reference_model(config).train(train)
    return ref_yolo.count_flops(model, batch, config["imgsz"], train)


def kernel_calls(config: dict, batch: int, train: bool):
    """The program's hand-kernel calls of one train step (train) or one
    forward (eval), as (work plug-in, shape) pairs: K2 on layers 0-1, K3 on
    the 3x3 convs of layer 2's bottlenecks (forward, and in a train step
    their dX and filter gradients), K1 once a train step."""
    s = config["scale"]
    size = config["imgsz"]

    def ch(base):
        return ref_yolo.make_divisible(min(base, s["max_channels"])
                                       * s["width"], 8)
    dt = config["precision"]["detector"]
    elt = 2 if dt == "bfloat16" else 4
    n_k3 = 2 * max(1, round(3 * s["depth"]))
    front = dict(batch=batch, size=size, c1=ch(64), c2=ch(128), elt=elt,
                 dtype=dt)
    k3 = dict(batch=batch, h=size // 4, w=size // 4, c=ch(128) // 2,
              elt=elt, dtype=dt)
    calls = [("k2_front", dict(front, backward=False))]
    calls += [("k3_conv3x3", dict(k3, wgrad=False))] * n_k3
    if train:
        calls += [("k1_corrupt", dict(batch=batch, h=size, w=size, c=3)),
                  ("k2_front", dict(front, backward=True))]
        calls += [("k3_conv3x3", dict(k3, wgrad=False))] * n_k3
        calls += [("k3_conv3x3", dict(k3, wgrad=True))] * n_k3
    return calls
