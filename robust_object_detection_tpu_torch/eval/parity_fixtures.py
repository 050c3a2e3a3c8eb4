"""External-parity harness: cross-check the scorer against REAL pycocotools
(counterpart of robust_object_detection_tpu/eval/parity_fixtures.py, over
the port's own scorer, eval/coco_map.py; host only).

The scorer's in-repo oracle (tests/test_coco_map.py) is a transcription
written by the same author — a shared misreading of the COCOeval protocol
would pass every test (round-2 verdict, "single-author oracle risk"). The
reference's ground truth is pycocotools itself (train_frcnn_baseline.py:15-16,
eval_all.py:131-156). pycocotools is absent from this image, so this module
ships the bridge instead:

  * a deterministic canned evaluation case (crowds, empty images, every area
    band, score ties, multi-class) built from a seed — byte-stable across
    hosts,
  * converters to the COCO json/results dict format pycocotools consumes,
  * `run_pycocotools()` — executes the real COCOeval on the canned case
    (only on hosts that have pycocotools),
  * fixture IO — the numbers of a real COCOeval run, written to
    tests/fixtures/ on a host that has pycocotools (`write_fixture`), after
    which the scorer is held against them on every host, pycocotools
    installed or not. The fixture is the reference's file and format.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import coco_map

FIXTURE_PATH = (Path(__file__).resolve().parents[2] / "tests" / "fixtures"
                / "pycoco_parity.json")

CATEGORIES = [1, 2, 3, 4, 5, 6]


def make_canned_eval_case(seed: int = 0, n_images: int = 24
                          ) -> Tuple[Dict[int, coco_map.Detections],
                                     Dict[int, coco_map.GroundTruth]]:
    """Deterministic detections+GT exercising the protocol's edge cases.

    Seeded numpy only — identical arrays on any host/platform, so fixture
    numbers generated elsewhere apply here. Includes: empty-GT images,
    zero-detection images, crowd GTs, boxes in all three COCO area bands,
    duplicate detections on one GT, exact score ties (stable-sort path),
    and detections of a class with no GT anywhere.
    """
    rng = np.random.RandomState(seed)
    detections: Dict[int, coco_map.Detections] = {}
    ground_truth: Dict[int, coco_map.GroundTruth] = {}
    for img_id in range(1, n_images + 1):
        n_gt = int(rng.randint(0, 14))
        if img_id == 3:
            n_gt = 0                              # empty-GT image
        # area bands: small (<32^2), medium, large (>96^2)
        side = rng.choice([8, 24, 48, 80, 160, 240], size=max(n_gt, 1))
        xy = rng.randint(0, 400, (max(n_gt, 1), 2)).astype(np.float64)
        gb = np.concatenate([xy, np.stack([side, side * rng.uniform(
            0.5, 1.5, len(side))], -1)], -1)[:n_gt]
        gc = rng.randint(1, 6, n_gt)              # class 6 never in GT
        crowd = rng.rand(n_gt) < 0.15
        ground_truth[img_id] = coco_map.GroundTruth(
            gb.astype(np.float64), gc.astype(int), crowd.astype(bool))

        if img_id == 5:                           # zero-detection image
            detections[img_id] = coco_map.Detections(
                np.zeros((0, 4)), np.zeros(0), np.zeros(0, int))
            continue
        # detections: jittered copies of GTs (some duplicated) + noise
        dts, scs, cls = [], [], []
        for j in range(n_gt):
            for _ in range(1 + int(rng.rand() < 0.3)):   # duplicates
                jitter = rng.randn(4) * np.array([4, 4, 6, 6])
                db = gb[j] + jitter
                db[2:] = np.maximum(db[2:], 2.0)
                dts.append(db)
                scs.append(round(float(rng.uniform(0.05, 0.99)), 2))
                cls.append(int(gc[j]) if rng.rand() < 0.85
                           else int(rng.randint(1, 7)))
        for _ in range(int(rng.randint(0, 5))):          # pure noise
            xy = rng.randint(0, 400, 2).astype(np.float64)
            wh = rng.uniform(4, 120, 2)
            dts.append(np.concatenate([xy, wh]))
            scs.append(round(float(rng.uniform(0.05, 0.99)), 2))
            cls.append(int(rng.randint(1, 7)))
        if img_id == 7 and len(scs) >= 2:
            scs[0] = scs[1] = 0.5                 # exact tie
        detections[img_id] = coco_map.Detections(
            np.asarray(dts, np.float64).reshape(-1, 4),
            np.asarray(scs, np.float64), np.asarray(cls, int))
    return detections, ground_truth


def to_coco_dicts(detections: Dict[int, coco_map.Detections],
                  ground_truth: Dict[int, coco_map.GroundTruth]
                  ) -> Tuple[dict, List[dict]]:
    """(gt dataset dict, results list) in pycocotools' loadable format."""
    images = [{"id": i, "width": 1000, "height": 1000}
              for i in sorted(ground_truth)]
    anns = []
    aid = 1
    for img_id in sorted(ground_truth):
        gt = ground_truth[img_id]
        for b, c, cr, a in zip(gt.boxes, gt.classes, gt.iscrowd, gt.areas):
            anns.append({"id": aid, "image_id": img_id,
                         "category_id": int(c),
                         "bbox": [float(v) for v in b],
                         "area": float(a), "iscrowd": int(cr)})
            aid += 1
    dataset = {"images": images, "annotations": anns,
               "categories": [{"id": c, "name": f"c{c}"}
                              for c in CATEGORIES]}
    results = []
    for img_id in sorted(detections):
        dt = detections[img_id]
        for b, s, c in zip(dt.boxes, dt.scores, dt.classes):
            results.append({"image_id": img_id, "category_id": int(c),
                            "bbox": [float(v) for v in b],
                            "score": float(s)})
    return dataset, results


def run_pycocotools(detections: Dict[int, coco_map.Detections],
                    ground_truth: Dict[int, coco_map.GroundTruth]
                    ) -> Dict[str, float]:
    """Real COCOeval numbers (requires pycocotools; raises ImportError)."""
    import contextlib
    import io

    from pycocotools.coco import COCO
    from pycocotools.cocoeval import COCOeval

    dataset, results = to_coco_dicts(detections, ground_truth)
    with contextlib.redirect_stdout(io.StringIO()):
        coco = COCO()
        coco.dataset = dataset
        coco.createIndex()
        coco_dt = coco.loadRes(results)
        ev = COCOeval(coco, coco_dt, iouType="bbox")
        ev.params.imgIds = sorted(ground_truth)
        ev.params.catIds = CATEGORIES
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
    out = {
        "mAP50_95": float(ev.stats[0]),
        "mAP50": float(ev.stats[1]),
        "mAP75": float(ev.stats[2]),
        "mAP_small": float(ev.stats[3]),
        "mAP_medium": float(ev.stats[4]),
        "mAP_large": float(ev.stats[5]),
    }
    # per-class AP@50 exactly as eval_all.py:146-156 slices it:
    # precision[0, :, k, 0, 2] mean over valid entries
    for k, cat in enumerate(CATEGORIES):
        pr = ev.eval["precision"][0, :, k, 0, 2]
        pr = pr[pr > -1]
        out[f"ap50_class_{cat}"] = float(pr.mean()) if pr.size else -1.0
    return out


def our_stats(detections: Dict[int, coco_map.Detections],
              ground_truth: Dict[int, coco_map.GroundTruth]
              ) -> Dict[str, float]:
    """The same numbers from this repo's scorer."""
    res = coco_map.evaluate(detections, ground_truth, CATEGORIES)
    out = coco_map.summarize(res)
    per_class = res.per_class_ap50
    for cat in CATEGORIES:
        out[f"ap50_class_{cat}"] = float(per_class.get(cat, -1.0))
    return out


def write_fixture(path: Path = FIXTURE_PATH, seeds: Sequence[int] = (0, 1, 2)
                  ) -> Path:
    """Run real pycocotools on the canned cases and persist the numbers."""
    cases = []
    for seed in seeds:
        det, gt = make_canned_eval_case(seed)
        cases.append({"seed": seed, "pycocotools": run_pycocotools(det, gt)})
    path.parent.mkdir(parents=True, exist_ok=True)
    import pycocotools
    payload = {
        "format": 1,
        "pycocotools_version": getattr(pycocotools, "__version__",
                                       "unknown"),
        "cases": cases,
    }
    path.write_text(json.dumps(payload, indent=1))
    return path


def load_fixture(path: Path = FIXTURE_PATH) -> dict | None:
    if not path.exists():
        return None
    return json.loads(path.read_text())
