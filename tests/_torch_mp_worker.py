"""One rank of a gloo process group on the CPU, for
tests/test_torch_multiprocess.py (not collected: no ``test_`` prefix).

    python tests/_torch_mp_worker.py NAME[,NAME...] WORKDIR

with ROD_COORDINATOR / ROD_NUM_PROCESSES / ROD_PROCESS_ID set. Each name
(a runner, optionally with a ``-suffix``: ``yolo-aug`` runs ``yolo``)
reads its inputs from ``WORKDIR/NAME.in.pt`` (written by the test), runs
the port's data- or tensor-parallel path, and writes
``NAME.rank{r}.pt``.
ROD_TEST_MUTATE=grad drops the gradient all-reduce, =bn the BatchNorm
statistics' all-reduce (the mutations the tests must see). Under the
decoder split (``rtdetr_tp``), ROD_TEST_MUTATE=tp_grad,tp_match lets the
runners ``rtdetr_tp-tp_grad`` and ``rtdetr_tp-tp_match`` of one launch
each perturb model index 1: +1e-3 on one replicated leaf's gradient, or
two queries' assignments swapped in its matchings. The runners are plain
functions, so the test runs the same code in one process for the
reference side.
"""

import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

from robust_object_detection_tpu_torch.core.config import (  # noqa: E402
    CorruptionConfig, ExperimentConfig, MeshConfig, RestorationConfig,
    TrainConfig)
from robust_object_detection_tpu_torch.parallel import \
    distributed  # noqa: E402
from robust_object_detection_tpu_torch.parallel import \
    mesh as mesh_lib  # noqa: E402

CPU = torch.device("cpu")
FRCNN_SMALL = dict(blocks=(1, 1, 1, 1), pre_nms_topk=64, num_proposals=32,
                   rpn_batch=32, roi_batch=32)


def _state_of(model, extra=None):
    out = {"state": {k: v.detach().clone()
                     for k, v in model.state_dict().items()}}
    out.update(extra or {})
    return out


def run_yolo(d, mesh):
    """`steps` YOLOv8n steps from d["state"] on this rank's rows of the
    global batch d["images"], d["boxes"], d["classes"], computing in
    d["dtype"] (f32 when absent; bf16 with bf16 BatchNorm outputs over f32
    master weights, as ``yolov8.create(train=True)`` builds it). "grads":
    SGD's momentum after the first step, that step's summed gradients plus
    the weight decay of the unchanged weights."""
    from robust_object_detection_tpu_torch.models import yolov8 as TY
    from robust_object_detection_tpu_torch.train import detector as TD
    dtype = d.get("dtype", torch.float32)
    model = TY.YoloV8(TY.YoloConfig(6, "n"), dtype,
                      param_dtype=torch.float32, bn_dtype=dtype)
    model.load_state_dict(d["state"])
    model.train()
    state = TD.init_state(model, TD.make_optimizer(warmup_steps=1,
                                                   total_steps=10)[0])
    step = TD.make_train_step(d["img"], CorruptionConfig(),
                              augment=d["augment"],
                              base_augment=d["augment"], mesh=mesh)
    images, boxes, classes = mesh_lib.shard_batch(
        mesh, (d["images"], d["boxes"], d["classes"]))
    metrics, grads = [], {}
    for s in range(d["steps"]):
        m = step(state, images, boxes, classes,
                 torch.Generator().manual_seed(s))
        metrics.append({k: float(v) for k, v in m.items()})
        if s == 0:
            grads = {n: state.optimizer.state[p]["momentum_buffer"].clone()
                     for n, p in model.named_parameters()
                     if p in state.optimizer.state}
    return _state_of(model, {"metrics": metrics, "ema": state.ema,
                             "grads": grads})


def run_frcnn(d, mesh):
    """One Faster R-CNN step (small config) with the global draws d["draws"]
    on this rank's rows."""
    from robust_object_detection_tpu_torch.models import frcnn as TF
    from robust_object_detection_tpu_torch.train import frcnn as TT
    model = TF.FasterRCNN(TF.FrcnnConfig(**FRCNN_SMALL))
    model.load_state_dict(d["state"])
    state = TT.init_state(model, TT.make_optimizer(steps_per_epoch=1)[0])
    step = TT.make_train_step(model, d["img"], CorruptionConfig(), True,
                              mesh)
    images, boxes, classes = mesh_lib.shard_batch(
        mesh, (d["images"], d["boxes"], d["classes"]))
    m = step(state, images, boxes, classes, 0, d["draws"])
    return _state_of(model, {"metrics": [{k: float(v)
                                          for k, v in m.items()}]})


def run_unet(d, mesh):
    """One U-Net step (small channels) with the global draws d["draws"];
    d["f64"]: in float64 (the model, and ``Tensor.float`` widened while
    the step runs)."""
    from robust_object_detection_tpu_torch.models import unet as TU
    from robust_object_detection_tpu_torch.train import restoration as TR
    f64 = d.get("f64", False)
    model = TU.RestorationUNet(d["channels"],
                               torch.float64 if f64 else torch.float32)
    model.load_state_dict(d["state"])
    model.train()
    if f64:
        model.double()
        real = torch.Tensor.float
        torch.Tensor.float = lambda self: self.double()
        try:
            return _unet_step(d, mesh, model, TR)
        finally:
            torch.Tensor.float = real
    return _unet_step(d, mesh, model, TR)


def _unet_step(d, mesh, model, TR):
    rcfg = RestorationConfig(channels=d["channels"])
    state = TR.init_state(model, TR.make_optimizer(rcfg, 4)[0])
    step = TR.make_train_step(CorruptionConfig(), rcfg.ssim_weight, mesh)
    m = step(state, mesh_lib.shard_batch(mesh, d["images"]), None,
             d["draws"])
    # AdamW's first update is about lr x sign(g): the summed gradients
    # (left in .grad by the step) are what to compare
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return _state_of(model, {"metrics": [{k: float(v)
                                          for k, v in m.items()}],
                             "grads": grads})


def lookup_predict(samples, img, max_det=8):
    """A predict fn for the sharded-eval check: each image's detections are
    its own GT boxes, jittered and scored by a fixed rule, plus one false
    positive, found by the image's bytes (so any sharding of a batch gives
    the same detections for the same image)."""
    from robust_object_detection_tpu_torch.data import pipeline as pipe
    table = {}
    rng = np.random.RandomState(0)
    for batch in pipe.make_batches(samples, 1, img, max_boxes=max_det - 1):
        key = batch.images[0].tobytes()
        v = batch.classes[0] >= 0
        boxes = np.zeros((max_det, 4), np.float32)
        scores = np.zeros((max_det,), np.float32)
        classes = np.zeros((max_det,), np.int32)
        k = int(v.sum())
        boxes[:k] = batch.boxes[0][v] + rng.uniform(-3, 3, (k, 4))
        scores[:k] = rng.uniform(0.2, 1.0, k)
        classes[:k] = np.where(rng.rand(k) < 0.8, batch.classes[0][v], 0)
        boxes[k] = [1, 1, 20, 20]
        scores[k] = rng.uniform(0.2, 1.0)
        valid = np.arange(max_det) <= k
        table[key] = tuple(torch.from_numpy(a) for a in
                           (boxes, scores, classes, valid))

    def predict(_state, images):
        rows = [table[im.numpy().tobytes()] for im in images]
        return tuple(torch.stack(t) for t in zip(*rows))
    return predict


def run_eval(d, mesh):
    from robust_object_detection_tpu_torch.data import pipeline as pipe
    from robust_object_detection_tpu_torch.eval import detector_eval as DE
    samples = pipe.index_coco(d["root"], "val")
    predict = lookup_predict(samples, d["img"])
    s = DE.evaluate_on_samples(predict, None, samples, d["img"], 4, CPU,
                               max_boxes=16, mesh=mesh)
    return {"summary": {k: s[k] for k in ("mAP50", "mAP50_95", "images")}}


def run_detector_train(d, mesh):
    from robust_object_detection_tpu_torch.train import detector as TD
    cfg = ExperimentConfig(train=TrainConfig(seed=0))
    r = TD.train(cfg, d["root"], d["out"], augment=True, variant="n",
                 epochs=1, img_size=64, batch_size=4, max_boxes=16,
                 mosaic=False, base_augment=True, device=CPU)
    return {"result": r}


def run_rtdetr_train(d, mesh):
    from robust_object_detection_tpu_torch.train import rtdetr as TR
    calls = []
    real = mesh_lib.rtdetr_decoder_tp

    def spy(ctx, module):
        calls.append(True)
        return real(ctx, module)
    mesh_lib.rtdetr_decoder_tp = spy
    try:
        cfg = ExperimentConfig(train=TrainConfig(seed=0),
                               mesh=MeshConfig(**d["mesh"]))
        r = TR.train(cfg, d["root"], d["out"], augment=False, epochs=1,
                     img_size=64, batch_size=2, max_steps=3, max_boxes=16,
                     mosaic=False, base_augment=False, val_interval=0,
                     model_kwargs=dict(queries=24, dec_layers=2),
                     device=CPU)
    finally:
        mesh_lib.rtdetr_decoder_tp = real
    return {"result": r, "tp_plans": len(calls)}


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (bit equality across processes)."""
    t = t.detach().cpu().contiguous().reshape(-1)
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()


# the suffix of the runner being run (rtdetr_tp-<mutation>)
_CURRENT = [""]


def _mutating(kind: str) -> bool:
    return (kind in os.environ.get("ROD_TEST_MUTATE", "").split(",")
            and _CURRENT[0] == kind)


def run_rtdetr_tp(d, mesh):
    """d["steps"] RT-DETR steps (queries 24, 2 decoder layers, f32) with
    the decoder split over a 2-way model axis, both ranks on the whole
    batch. After each step, SHA-256 digests of every replicated leaf (the
    plan's None leaves), its gradient as the global norm reads it and as
    the gradient all-reduce left it, its EMA and AdamW moments, every
    buffer, and each matching as the losses read it and as the matcher
    returned it; and the metrics."""
    from robust_object_detection_tpu_torch.models import rtdetr as TRM
    from robust_object_detection_tpu_torch.train import rtdetr as TR
    tp = mesh_lib.make_mesh(MeshConfig(data=1, model=2))
    model = TRM.create(6, torch.float32, CPU,
                       torch.Generator().manual_seed(0), train=True,
                       queries=24, dec_layers=2)
    plan = mesh_lib.rtdetr_decoder_tp(tp, model)
    mesh_lib.apply_tp(tp, model, plan)
    state = TR.init_state(model, TR.make_optimizer(warmup_steps=1,
                                                   total_steps=10)[0])
    state.tp_plan = plan
    rep = [(n, p) for n, p in model.named_parameters()
           if plan.get(n) is None and p.requires_grad]
    if _mutating("tp_grad") and tp.model_index == 1:
        leaf = next(p for n, p in rep if ".decoder." in f".{n}")

        def perturb(p):
            p.grad.add_(1e-3)
        leaf.register_post_accumulate_grad_hook(perturb)
    rec = {}
    real = (TR.hungarian_match, TR.auction_assignment,
            mesh_lib.all_reduce_grads, TR.global_grad_norm)

    def grads():
        return {n: digest(p.grad) for n, p in rep if p.grad is not None}

    def match(*a, **k):
        out = real[0](*a, **k)
        rec["match"].append(digest(out[0]) + digest(out[2]["capped"]))
        return out

    def auction(*a, **k):
        gfq, capped = real[1](*a, **k)
        if _mutating("tp_match") and tp.model_index == 1:
            row = gfq[0]
            j = int((row != row[0]).nonzero()[0])
            row[0], row[j] = row[j].clone(), row[0].clone()
        rec["matcher"].append(digest(gfq) + digest(capped))
        return gfq, capped

    def reduce(*a, **k):
        real[2](*a, **k)
        rec["grad_reduced"] = grads()

    def norm(*a, **k):
        rec["grad"] = grads()
        return real[3](*a, **k)
    TR.hungarian_match, TR.auction_assignment = match, auction
    mesh_lib.all_reduce_grads, TR.global_grad_norm = reduce, norm
    step = TR.make_train_step(d["img"], CorruptionConfig(), augment=False,
                              base_augment=True, mesh=tp)
    out = []
    try:
        for s in range(d["steps"]):
            rec.update(match=[], matcher=[])
            m = step(state, d["images"], d["boxes"], d["classes"],
                     torch.Generator().manual_seed(s))
            opt = state.optimizer.state
            rec.update(
                metrics={k: float(v) for k, v in m.items()},
                params={n: digest(p) for n, p in rep},
                ema={n: digest(state.ema[n]) for n, _ in rep},
                moments={f"{n}.{k}": digest(opt[p][k]) for n, p in rep
                         if p in opt for k in ("exp_avg", "exp_avg_sq")},
                buffers={n: digest(b) for n, b in model.named_buffers()})
            out.append(dict(rec))
    finally:
        (TR.hungarian_match, TR.auction_assignment,
         mesh_lib.all_reduce_grads, TR.global_grad_norm) = real
    return {"steps": out, "model_index": tp.model_index}


RUNNERS = {"yolo": run_yolo, "frcnn": run_frcnn, "unet": run_unet,
           "eval": run_eval, "detector_train": run_detector_train,
           "rtdetr_train": run_rtdetr_train, "rtdetr_tp": run_rtdetr_tp}


def _mutate(kind: str) -> None:
    """Break one collective of the data-parallel step, in this process."""
    from robust_object_detection_tpu_torch.ops import yolo_front
    if kind == "grad":
        mesh_lib.all_reduce_grads = lambda *a, **k: None
    elif kind == "bn":
        def local(mean, meansq):
            return mean, meansq
        mesh_lib.sync_moments = local
        yolo_front.sync_moments = local


def main() -> int:
    names, work = sys.argv[1].split(","), Path(sys.argv[2])
    assert distributed.maybe_initialize("cpu"), "no process group"
    if os.environ.get("ROD_TEST_MUTATE"):
        _mutate(os.environ["ROD_TEST_MUTATE"])
    rank = torch.distributed.get_rank()
    mesh = mesh_lib.make_mesh(MeshConfig())
    for name in names:
        d = torch.load(work / f"{name}.in.pt", weights_only=False)
        _CURRENT[0] = name.partition("-")[2]
        out = RUNNERS[name.split("-")[0]](d, mesh)
        torch.save(out, work / f"{name}.rank{rank}.pt")
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "names": names}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
