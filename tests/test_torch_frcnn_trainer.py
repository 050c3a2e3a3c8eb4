"""The port's Faster R-CNN training driver (train/frcnn.{train,
load_checkpoint, load_pretrained}) and its validation helpers
(train/validation.py), on a COCO root written by the reference's
``data.synthetic.make_det_split`` and ``data.convert.convert_det_to_coco``
(as tests/test_frcnn_buckets.py builds one), at tiny sizes: blocks (1, 1,
1, 1), 64 px canvases, 8 train and 4 val images, batch 2, on the CPU.

The reference's own ``train`` is not run here (its CPU compile of the
sharded step is the slow tier's); what is held against the reference is
what the driver shares with it: the ``config.json`` stamp's keys and
values, ``should_validate``'s schedule, ``native_res_epoch_plan``'s drops,
and ``pretrained=`` against ``pretrained.import_frcnn(strict_head=False)``
on the same weights.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from robust_object_detection_tpu.data import convert as jconvert
from robust_object_detection_tpu.data import synthetic
from robust_object_detection_tpu.models import frcnn as JF
from robust_object_detection_tpu.models import pretrained
from robust_object_detection_tpu.train import frcnn as JT
from robust_object_detection_tpu.train import validation as JV
from robust_object_detection_tpu_torch.core import artifacts
from robust_object_detection_tpu_torch.core.checkpoint import \
    CheckpointManager
from robust_object_detection_tpu_torch.core.config import (ExperimentConfig,
                                                           TrainConfig)
from robust_object_detection_tpu_torch.data import pipeline
from robust_object_detection_tpu_torch.eval import detector_eval
from robust_object_detection_tpu_torch.models import convert
from robust_object_detection_tpu_torch.models import frcnn as TF
from robust_object_detection_tpu_torch.train import frcnn as TT
from robust_object_detection_tpu_torch.train import validation as TV

torch.set_num_threads(1)

SMALL = dict(blocks=(1, 1, 1, 1), pre_nms_topk=64, num_proposals=32,
             roi_batch=32, rpn_batch=32)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("frcnn_data")
    for split, n, seed in (("train", 8, 0), ("val", 4, 1)):
        det = synthetic.make_det_split(root / f"det_{split}", n_images=n,
                                       seed=seed,
                                       size_range=((40, 80), (40, 80)))
        jconvert.convert_det_to_coco(det, root / "coco", split)
    return root / "coco"


def _cfg(seed=0):
    return ExperimentConfig(train=TrainConfig(seed=seed))


def _train(root, out, **kw):
    args = dict(epochs=2, img_size=64, batch_size=2, max_boxes=16,
                model_kwargs=SMALL, device=CPU)
    args.update(kw)
    return TT.train(_cfg(), root, out, **args)


def test_should_validate_matches_reference():
    for epochs in (1, 3, 24):
        for interval in (0, 1, 2, 5):
            for have in (False, True):
                for epoch in range(1, epochs + 1):
                    assert TV.should_validate(epoch, epochs, interval, have) \
                        == JV.should_validate(epoch, epochs, interval, have)


def test_index_val_samples(coco_root, tmp_path):
    got = TV.index_val_samples(coco_root)
    assert [s.image_id for s in got] == [1, 2, 3, 4]
    assert TV.index_val_samples(tmp_path) == []


@pytest.fixture(scope="module")
def square_run(coco_root, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("square") / "run"
    return out_dir, _train(coco_root, out_dir, val_interval=1)


def test_train_square_canvas_history_stamp_and_validation(square_run):
    run, out = square_run
    assert out["steps"] == 8 and np.isfinite(out["final_loss"])
    hist = artifacts.read_jsonl(run / "history.jsonl")
    assert [h["epoch"] for h in hist] == [1, 2]
    for h in hist:
        assert {"train_loss", "lr", "epoch_sec", "mAP50",
                "mAP50_95"} <= set(h) and "dropped_images" not in h
        assert 0.0 <= h["mAP50"] <= 1.0 and 0.0 <= h["mAP50_95"] <= 1.0
        assert np.isfinite(h["train_loss"]) and h["lr"] == 0.005
    # the stamp the reference's train() writes for the same arguments,
    # plus the compute dtype the port records (f32 on the CPU)
    stamp = json.loads((run / "config.json").read_text())
    want = {"frcnn": dataclasses.asdict(JF.FrcnnConfig(trainable_layers=5,
                                                       **SMALL)),
            "augment": False, "img_size": 64, "batch_size": 2, "epochs": 2,
            "native_res": False}
    assert stamp.pop("dtype") == "float32"
    assert stamp == json.loads(json.dumps(want))
    ckpt = run / "ckpt"
    assert (ckpt / "best").exists() and (ckpt / "last" / "2").exists()
    meta = json.loads((ckpt / "best_meta.json").read_text())
    assert meta["metric"] == max(h["mAP50"] for h in hist)


def test_train_native_res_counts_dropped_images(coco_root, tmp_path):
    out = _train(coco_root, tmp_path / "run", epochs=1, native_res=True,
                 min_side=48.0, max_side=96.0, bucket_mult=32)
    hist = artifacts.read_jsonl(tmp_path / "run" / "history.jsonl")
    assert [h["epoch"] for h in hist] == [1]
    # the plan the reference would make for the same buckets
    buckets = {}
    for s in pipeline.index_coco(coco_root, "train"):
        th, tw, _ = detector_eval.tv_target(s.height, s.width, 48.0, 96.0)
        buckets.setdefault((-(-th // 32) * 32, -(-tw // 32) * 32),
                           []).append(s.image_id)
    chunks, dropped = JT.native_res_epoch_plan(buckets, 2, 0 + 1)
    assert len(buckets) > 1
    assert hist[0]["dropped_images"] == dropped
    assert out["steps"] == len(chunks) and np.isfinite(out["final_loss"])
    assert json.loads((tmp_path / "run" / "config.json").read_text())[
        "native_res"] is True


def test_resume_after_one_epoch_is_bit_identical(coco_root, tmp_path):
    """Two epochs in one run vs one epoch, then a second run that resumes
    from ``last``: the same parameters, running statistics, momentum
    buffers and step, bit for bit."""
    _train(coco_root, tmp_path / "whole", augment=True)
    _train(coco_root, tmp_path / "split", augment=True, epochs=1)
    assert json.loads(
        (tmp_path / "split" / "ckpt" / "best_meta.json").read_text())
    out = _train(coco_root, tmp_path / "split", augment=True)
    assert out["steps"] == 8
    whole = torch.load(tmp_path / "whole" / "ckpt" / "last" / "2",
                       weights_only=True)["state"]
    split = torch.load(tmp_path / "split" / "ckpt" / "last" / "2",
                       weights_only=True)["state"]
    assert whole["step"] == split["step"] == 8
    assert whole["model"].keys() == split["model"].keys()
    for k, v in whole["model"].items():
        assert torch.equal(v, split["model"][k]), k
    for k, v in whole["optimizer"]["state"].items():
        assert torch.equal(v["momentum_buffer"],
                           split["optimizer"]["state"][k]["momentum_buffer"])
    hist = artifacts.read_jsonl(tmp_path / "split" / "history.jsonl")
    assert [h["epoch"] for h in hist] == [1, 2]


def test_load_checkpoint_honours_the_stamp(square_run):
    run, _ = square_run
    model = TT.load_checkpoint(run, device=CPU)
    assert model.cfg == TF.FrcnnConfig(**SMALL)     # not the default cfg
    assert not model.training
    best = torch.load(run / "ckpt" / "best", weights_only=True)["state"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k]), k


def test_load_checkpoint_falls_back_to_the_classic_fpn(tmp_path):
    """An unstamped checkpoint of the bias-conv FPN loads with
    fpn_norm=False; a missing one raises FileNotFoundError."""
    cfg = TF.FrcnnConfig(fpn_norm=False, **SMALL)
    legacy = TF.create(cfg, device=CPU,
                       generator=torch.Generator().manual_seed(3))
    ckpt = CheckpointManager(tmp_path / "old")
    ckpt.save_last(1, {"model": legacy.state_dict()})
    model = TT.load_checkpoint(tmp_path / "old", TF.FrcnnConfig(**SMALL),
                               device=CPU)
    assert model.cfg.fpn_norm is False
    for k, v in legacy.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError):
        TT.load_checkpoint(tmp_path / "none", device=CPU)


def test_entry_points_need_a_device_without_a_card(coco_root, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TT.train(_cfg(), coco_root, tmp_path / "run", epochs=1, img_size=64,
                 model_kwargs=SMALL)
    _train(coco_root, tmp_path / "ok", epochs=1, max_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TT.load_checkpoint(tmp_path / "ok")


def _full_width_variables(seed):
    """The reference's full-width 7-class variables from its tree's shapes
    (jax.eval_shape: no compile), every leaf drawn from `seed`."""
    model = JF.FasterRCNN(JF.FrcnnConfig())
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jax.numpy.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: (rng.randn(*s.shape) * 0.05).astype(np.float32), shapes)


def test_pretrained_matches_import_frcnn_non_strict_head(tmp_path):
    """A seeded COCO-91 torchvision-layout state_dict onto the 7-class
    model: the port's load_pretrained gives the weights the reference's
    import_frcnn(strict_head=False) gives on the same starting variables
    (the predictor keeps its fresh init), bit for bit; a mismatched tensor
    elsewhere raises."""
    coco = TF.FasterRCNN(TF.FrcnnConfig(num_classes=91))
    TF.init_weights(coco, torch.Generator().manual_seed(5))
    sd = {k: v.clone() for k, v in coco.state_dict().items()}
    g = torch.Generator().manual_seed(6)
    for k, v in sd.items():
        if "running_var" in k:
            v.copy_(torch.rand(v.shape, generator=g) + 0.5)
        elif v.is_floating_point():
            v.add_(torch.randn(v.shape, generator=g) * 0.01)
    torch.save({"model": sd}, tmp_path / "coco.pth")

    v = _full_width_variables(7)
    model = TF.FasterRCNN(TF.FrcnnConfig())
    model.load_state_dict(convert.frcnn_from_jax_variables(
        v["params"], v["batch_stats"], model.cfg))
    fresh = {k: t.clone() for k, t in model.state_dict().items()}
    report = TT.load_pretrained(model, tmp_path / "coco.pth")
    assert len(report["skipped"]) == 4
    ref, jreport = pretrained.import_frcnn(
        {k: t.numpy() for k, t in sd.items()}, v, strict_head=False)
    assert len(jreport.skipped) == 2         # weight + bias, as two layers
    want = convert.frcnn_from_jax_variables(ref["params"],
                                            ref["batch_stats"], model.cfg)
    got = model.state_dict()
    for k, t in want.items():
        assert torch.equal(got[k], t), k
    for k in ("roi_heads.box_predictor.cls_score.weight",
              "roi_heads.box_predictor.bbox_pred.bias"):
        assert torch.equal(got[k], fresh[k])
    assert torch.equal(got["backbone.body.conv1.weight"],
                       sd["backbone.body.conv1.weight"])

    bad = dict(sd, **{"rpn.head.cls_logits.bias": torch.zeros(5)})
    with pytest.raises(ValueError, match="cls_logits"):
        TT.load_pretrained(TF.FasterRCNN(TF.FrcnnConfig()), bad)


def test_train_from_pretrained_freezes_three_layers(coco_root, tmp_path):
    """pretrained= with trainable_layers None resolves to 3: after a step
    the stem and layer1 hold the pretrained values, layer2 moved."""
    src = TF.create(TF.FrcnnConfig(**SMALL), device=CPU,
                    generator=torch.Generator().manual_seed(9))
    sd = src.state_dict()
    _train(coco_root, tmp_path / "run", epochs=1, max_steps=2,
           pretrained=sd)
    last = torch.load(tmp_path / "run" / "ckpt" / "last" / "1",
                      weights_only=True)["state"]["model"]
    stamp = json.loads((tmp_path / "run" / "config.json").read_text())
    assert stamp["frcnn"]["trainable_layers"] == 3
    for k in ("backbone.body.conv1.weight", "backbone.body.bn1.bias",
              "backbone.body.layer1.0.conv2.weight"):
        assert torch.equal(last[k], sd[k]), k
    assert not torch.equal(last["backbone.body.layer1.0.bn1.running_mean"],
                           sd["backbone.body.layer1.0.bn1.running_mean"])
    assert not torch.equal(last["backbone.body.layer2.0.conv2.weight"],
                           sd["backbone.body.layer2.0.conv2.weight"])
