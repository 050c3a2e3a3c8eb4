"""One rank of a gloo process group on the CPU, for
tests/test_torch_multiprocess.py (not collected: no ``test_`` prefix).

    python tests/_torch_mp_worker.py NAME[,NAME...] WORKDIR

with ROD_COORDINATOR / ROD_NUM_PROCESSES / ROD_PROCESS_ID set. Each name
(a runner, optionally with a ``-suffix``: ``yolo-aug`` runs ``yolo``)
reads its inputs from ``WORKDIR/NAME.in.pt`` (written by the test), runs
the port's data- or tensor-parallel path, and writes
``NAME.rank{r}.pt``.
ROD_TEST_MUTATE=grad drops the gradient all-reduce, =bn the BatchNorm
statistics' all-reduce (the mutations the tests must see). The runners
are plain functions, so the test runs the same code in one process for
the reference side.
"""

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
    global batch d["images"], d["boxes"], d["classes"]."""
    from robust_object_detection_tpu_torch.models import yolov8 as TY
    from robust_object_detection_tpu_torch.train import detector as TD
    model = TY.YoloV8(TY.YoloConfig(6, "n"))
    model.load_state_dict(d["state"])
    model.train()
    state = TD.init_state(model, TD.make_optimizer(warmup_steps=1,
                                                   total_steps=10)[0])
    step = TD.make_train_step(d["img"], CorruptionConfig(),
                              augment=d["augment"],
                              base_augment=d["augment"], mesh=mesh)
    images, boxes, classes = mesh_lib.shard_batch(
        mesh, (d["images"], d["boxes"], d["classes"]))
    metrics = []
    for s in range(d["steps"]):
        m = step(state, images, boxes, classes,
                 torch.Generator().manual_seed(s))
        metrics.append({k: float(v) for k, v in m.items()})
    return _state_of(model, {"metrics": metrics, "ema": state.ema})


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


RUNNERS = {"yolo": run_yolo, "frcnn": run_frcnn, "unet": run_unet,
           "eval": run_eval, "detector_train": run_detector_train,
           "rtdetr_train": run_rtdetr_train}


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
        out = RUNNERS[name.split("-")[0]](d, mesh)
        torch.save(out, work / f"{name}.rank{rank}.pt")
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "names": names}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
