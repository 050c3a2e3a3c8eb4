"""Pretrained weight files that pickle a whole ``nn.Module`` (an Ultralytics
``.pt``): ``core.checkpoint.load_weights`` against the reference's
``models/pretrained.load_checkpoint_state``, every trainer's
``load_pretrained`` with ``allow_pickle``, and the CLI's ``--allow-pickle``
reaching each trainer.

  * a ``torch.save``d module of the port's own YOLOv8 class, under
    ``"ema"``, under ``"model"`` or at the top, loads with
    ``allow_pickle=True`` into the state_dict of the exported file, equal
    to the reference's arrays for the same file, and raises a ValueError
    naming ``allow_pickle`` without it;
  * YOLOv8, RT-DETR-L (two decoder layers) and Faster R-CNN take such a
    file through their ``load_pretrained``;
  * ``train-detector --allow-pickle`` hands ``allow_pickle=True`` to the
    trainer of each model.
"""

import numpy as np
import pytest
import torch

from robust_object_detection_tpu.models import pretrained as jpretrained
from robust_object_detection_tpu_torch import cli as tcli
from robust_object_detection_tpu_torch.core import checkpoint as ckpt
from robust_object_detection_tpu_torch.models import frcnn as TF
from robust_object_detection_tpu_torch.models import rtdetr as TR
from robust_object_detection_tpu_torch.models import yolov8 as TY
from robust_object_detection_tpu_torch.train import detector as TD
from robust_object_detection_tpu_torch.train import frcnn as TFR
from robust_object_detection_tpu_torch.train import rtdetr as TRT

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _yolo(seed):
    return TY.create(6, "n", device=CPU, train=True,
                     generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("wrap", ["ema", "model", None])
def test_pickled_module_loads_only_with_allow_pickle(wrap, tmp_path):
    module = _yolo(3)
    payload = module if wrap is None else {wrap: module, "epoch": 7}
    if wrap == "ema":
        payload["model"] = _yolo(4)      # "ema" wins, as the reference's
    torch.save(payload, tmp_path / "ultra.pt")
    torch.save(module.state_dict(), tmp_path / "exported.pt")
    with pytest.raises(ValueError, match="allow_pickle"):
        ckpt.load_weights(tmp_path / "ultra.pt")
    with pytest.raises(ValueError, match="allow_pickle"):
        TD.load_pretrained(_yolo(0), tmp_path / "ultra.pt")
    got = ckpt.load_weights(tmp_path / "ultra.pt", allow_pickle=True)
    want = ckpt.load_weights(tmp_path / "exported.pt")
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ref = jpretrained.load_checkpoint_state(str(tmp_path / "ultra.pt"),
                                            allow_pickle=True)
    floats = {k for k, v in got.items() if v.is_floating_point()}
    assert set(ref) >= floats
    for k in floats:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])


def _check_trainer_load(load, make, tmp_path):
    """`load(model, path, allow_pickle)` of a pickled {"ema": module} gives
    the module's weights; without allow_pickle it raises."""
    src = make(1)
    torch.save({"ema": src}, tmp_path / "ultra.pt")
    model = make(2)
    with pytest.raises(ValueError, match="allow_pickle"):
        load(model, tmp_path / "ultra.pt", False)
    report = load(model, tmp_path / "ultra.pt", True)
    assert report["imported"] and not report["skipped"]
    want = src.state_dict()
    for k, t in model.state_dict().items():
        assert torch.equal(t, want[k]), k


def test_yolo_trainer_loads_a_pickled_module(tmp_path):
    _check_trainer_load(
        lambda m, p, a: TD.load_pretrained(m, p, allow_pickle=a), _yolo,
        tmp_path)


def test_rtdetr_trainer_loads_a_pickled_module(tmp_path):
    def make(seed):
        return TR.create(6, device=CPU, train=True, dec_layers=2,
                         generator=torch.Generator().manual_seed(seed))
    _check_trainer_load(
        lambda m, p, a: TD.load_pretrained(m, p, TRT.RTDETR_HEADS,
                                           (TRT.DN_TABLE,), allow_pickle=a),
        make, tmp_path)


def test_frcnn_trainer_loads_a_pickled_module(tmp_path):
    def make(seed):
        model = TF.FasterRCNN(TF.FrcnnConfig())
        TF.init_weights(model, torch.Generator().manual_seed(seed))
        return model
    _check_trainer_load(
        lambda m, p, a: TFR.load_pretrained(m, p, allow_pickle=a), make,
        tmp_path)


@pytest.mark.parametrize("model, module", [("yolo", TD), ("rtdetr", TRT),
                                           ("frcnn", TFR)])
def test_cli_allow_pickle_reaches_the_trainer(model, module, tmp_path,
                                              monkeypatch):
    seen = {}
    monkeypatch.setattr(module, "train",
                        lambda *a, **k: seen.update(k) or {})
    common = ["train-detector", "--model", model, "--data-root",
              str(tmp_path), "--out", str(tmp_path / "o"), "--pretrained",
              str(tmp_path / "w.pt"), "--device", "cpu"]
    tcli.main(common)
    assert seen["allow_pickle"] is False
    tcli.main(common + ["--allow-pickle"])
    assert seen["allow_pickle"] is True
    assert seen["pretrained"] == str(tmp_path / "w.pt")
