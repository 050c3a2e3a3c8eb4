"""Typed configuration (counterpart of
robust_object_detection_tpu/core/config.py).

The reference's ``core`` package imports jax on import, so the port keeps
its own copy: one tree of frozen dataclasses, serialisable to and from
JSON. Fields and defaults are identical to the reference's, so a JSON file
written by either package's ``save`` loads in the other. In particular
training-time corruption and testset generation share ``CorruptionConfig``
byte for byte.

``MeshConfig`` factors the process group into the (data, model) mesh of
parallel/mesh.py.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class CorruptionConfig:
    noise_sigma: float = 15.0
    blur_kernel: int = 9
    blur_angle_deg: float = 0.0
    downscale_factor: float = 0.5
    # Probability that a training sample is corrupted at all.
    prob: float = 0.5


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset roots and layout."""
    visdrone_det_train: str = "data/raw/VisDrone2019-DET-train"
    visdrone_det_val: str = "data/raw/VisDrone2019-DET-val"
    visdrone_vid_train: str = "data/raw/VisDrone2019-VID-train"
    visdrone_vid_val: str = "data/raw/VisDrone2019-VID-val"
    processed_root: str = "data/processed"
    testset_root: str = "data/testsets"
    image_size: int = 1024
    batch_size: int = 8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 100
    batch_size: int = 8
    lr: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 500
    seed: int = 42
    bf16: bool = True
    # rematerialise the backbone to trade FLOPs for device memory
    remat: bool = False
    checkpoint_every: int = 1
    log_every: int = 50


@dataclasses.dataclass(frozen=True)
class RestorationConfig:
    """The restoration U-Net experiment."""
    channels: Tuple[int, ...] = (32, 64, 128, 256)
    patch_size: int = 256
    epochs: int = 60
    batch_size: int = 8
    lr: float = 1e-3
    weight_decay: float = 1e-4
    lr_min: float = 1e-6
    ssim_weight: float = 0.3
    val_every: int = 5
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh layout: data x model axes over the processes (-1 = all
    remaining processes). Axis sizes of 1 disable an axis."""
    data: int = -1
    model: int = 1

    def axis_sizes(self, n_devices: int) -> Tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, n_devices // model)
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} != {n_devices} devices; "
                "set MeshConfig.data/model to factor the device count")
        return data, model


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    conf_threshold: float = 0.001
    iou_threshold: float = 0.7       # NMS IoU
    max_detections: int = 300
    # COCOeval conventions (maxDets=100 for the AP computation itself).
    map_max_dets: int = 100
    image_size: int = 1024
    batch_size: int = 8


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    out_root: str = "experiments"
    corruption: CorruptionConfig = dataclasses.field(
        default_factory=CorruptionConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    restoration: RestorationConfig = dataclasses.field(
        default_factory=RestorationConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)

    @property
    def out_dir(self) -> Path:
        return Path(self.out_root) / self.name


# ── (De)serialisation ────────────────────────────────────────────────────

def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def _from_mapping(cls: type, m: Mapping[str, Any]) -> Any:
    """Build `cls` from a mapping: unknown keys are ignored, missing keys
    take their defaults, nested mappings become the field's dataclass and
    lists become tuples."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in m:
            continue
        v = m[f.name]
        if isinstance(v, Mapping) and f.default_factory is not dataclasses.MISSING:
            v = _from_mapping(type(f.default_factory()), v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def from_dict(m: Mapping[str, Any]) -> ExperimentConfig:
    return _from_mapping(ExperimentConfig, m)


def load(path: str | Path) -> ExperimentConfig:
    return from_dict(json.loads(Path(path).read_text()))


def save(cfg: ExperimentConfig, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(to_dict(cfg), indent=2))


def override(cfg: Any, **updates: Any) -> Any:
    """Functional update with nested replace through keyword dicts, e.g.
    ``override(cfg, train={"lr": 3e-4}, name="exp2")``."""
    kwargs = {}
    for k, v in updates.items():
        cur = getattr(cfg, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, Mapping):
            v = override(cur, **v)
        kwargs[k] = v
    return dataclasses.replace(cfg, **kwargs)
