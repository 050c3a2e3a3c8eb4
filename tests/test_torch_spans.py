"""The port's stage spans (core/profiling.py): the recorder (nesting,
parents, ids, per-thread stacks, off by default), its clock against
``torch.profiler``'s, and the spans of the two benchmarked paths on the
CPU: one YOLOv8n train step and one fused 8-pass sweep, each equal with
recording on and off."""

import threading
import time

import numpy as np
import pytest
import torch

from robust_object_detection_tpu_torch.core import profiling as P
from robust_object_detection_tpu_torch.core.config import CorruptionConfig
from robust_object_detection_tpu_torch.data.pipeline import Sample
from robust_object_detection_tpu_torch.eval import fused_sweep as FS
from robust_object_detection_tpu_torch.models import unet as U
from robust_object_detection_tpu_torch.models import yolov8 as Y
from robust_object_detection_tpu_torch.train import detector as D

torch.set_num_threads(1)

IMG = 64
TRAIN_SPANS = ["train.step", "train.augment", "train.forward", "train.loss",
               "train.assign", "train.backward", "train.optimizer",
               "train.ema"]


def test_spans_nest_with_their_parents_ids_and_threads():
    seen = {}

    def worker():
        with P.span("w.outer"):
            with P.span("w.inner", k=1):
                seen["thread"] = threading.get_native_id()

    with P.recording() as rec:
        with P.span("a", step=3):
            with P.span("b", batch=0):
                # another thread's spans do not nest under this one's
                t = threading.Thread(target=worker)
                t.start()
                t.join()
            with P.span("c", pass_=7):
                pass
    assert P.span("after") is P.span("after again")
    names = [s.name for s in rec.spans]
    assert names == ["a", "b", "w.outer", "w.inner", "c"]
    parent = {s.name: (rec.spans[s.parent].name if s.parent is not None
                       else None) for s in rec.spans}
    assert parent == {"a": None, "b": "a", "w.outer": None,
                      "w.inner": "w.outer", "c": "a"}
    by = {s.name: s for s in rec.spans}
    assert by["a"].ids == {"step": 3} and by["c"].ids == {"pass_": 7}
    assert by["w.inner"].ids == {"k": 1}
    assert by["w.outer"].thread == by["w.inner"].thread == seen["thread"]
    assert by["a"].thread == threading.get_native_id() != seen["thread"]
    for s in rec.spans:
        assert s.start <= s.end
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    assert rec.counts() == {"a": 1, "b": 1, "w.outer": 1, "w.inner": 1,
                            "c": 1}


def test_recording_is_not_nested_and_ends_with_its_block():
    with P.recording() as rec:
        with pytest.raises(RuntimeError):
            with P.recording():
                pass
        with P.span("x"):
            pass
    with P.span("y"):
        pass
    assert [s.name for s in rec.spans] == ["x"]


def test_span_clock_holds_the_profilers_event():
    """A span around a 512x512 torch.mm holds that op's event of the
    profiler's trace, on the same clock: each edge within 0.5 ms."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(512, 512)
    with P.recording() as rec, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with P.span("mm"):
                torch.mm(a, a)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert len(events) == len(rec.spans) == 5
    for e, s in zip(events, rec.spans):
        assert s.start <= e.start_ns() and e.end_ns() <= s.end
        assert e.start_ns() - s.start < 5e5 and s.end - e.end_ns() < 5e5


def _batch(seed=1, b=2, m=6):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, IMG, IMG, 3)).astype(np.uint8)
    xy = rng.uniform(0, IMG * 0.6, (b, m, 2))
    wh = rng.uniform(IMG * 0.15, IMG * 0.4, (b, m, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(
        np.float32)
    classes = rng.randint(0, 6, (b, m)).astype(np.int32)
    classes[1, m - 2:] = -1
    return [torch.from_numpy(a) for a in (images, boxes, classes)]


def _train_once(record: bool):
    model = Y.create(6, "n", device="cpu", train=True,
                     generator=torch.Generator().manual_seed(0))
    state = D.init_state(model, D.make_optimizer(warmup_steps=1)[0])
    step = D.make_train_step(IMG, CorruptionConfig(prob=1.0), augment=True,
                             base_augment=True)
    state.step = 1                  # a step at a learning rate above 0
    gen = torch.Generator().manual_seed(0)
    if record:
        with P.recording() as rec:
            m = step(state, *_batch(), gen)
    else:
        rec = None
        m = step(state, *_batch(), gen)
    return state, m, rec


def _assert_same_tensors(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_step_spans_in_order_and_the_step_unchanged(monkeypatch):
    """One Augmented YOLOv8n step under recording() opens exactly the
    train spans, in order, under one train.step (train.assign under
    train.loss); its metrics, parameters, running statistics and EMA are
    bit-equal to the same step with recording off, which opens none."""
    on_state, on_m, rec = _train_once(True)

    def no_span(*args, **kwargs):
        raise AssertionError("a span was opened with recording off")
    monkeypatch.setattr(P, "_Open", no_span)
    off_state, off_m, _ = _train_once(False)
    monkeypatch.undo()

    assert [s.name for s in rec.spans] == TRAIN_SPANS
    root = rec.spans[0]
    assert root.parent is None and root.ids == {"step": 1}
    parents = [rec.spans[s.parent].name for s in rec.spans[1:]]
    assert parents == ["train.step"] * 3 + ["train.loss"] + \
        ["train.step"] * 3
    for a, b in zip(rec.spans[1:], rec.spans[2:]):
        assert a.end <= b.start or b.parent == rec.spans.index(a)
    _assert_same_tensors(on_m, off_m)
    _assert_same_tensors(on_state.model.state_dict(),
                         off_state.model.state_dict())
    _assert_same_tensors(on_state.ema, off_state.ema)
    assert on_state.step == off_state.step == 2


def _sweep(samples, images, record: bool):
    det = Y.create(6, "n", device="cpu",
                   generator=torch.Generator().manual_seed(0))
    unet = U.create((8, 16), device="cpu")
    inner = D.make_predict_step(IMG, num_candidates=64, max_det=16)
    outs = []

    def predict(model, canvas):
        outs.append(inner(model, canvas))
        return outs[-1]

    def call():
        summary = FS.run_fused_sweep(
            predict, det, unet, None, samples, IMG, 2, CorruptionConfig(),
            seed=5, num_threads=2, load_image=lambda s: images[s.image_id])
        for st in ("corrupted", "restored"):
            for v in summary[st].values():
                del v["images_per_sec"]         # the host's clock
        return summary, outs
    if not record:
        return call(), None
    with P.recording() as rec:
        return call(), rec


def test_fused_sweep_spans_and_the_summaries_unchanged():
    """Three 32x48 images at batch 2 through the 8-pass sweep: one
    sweep.call; per batch one sweep.load, sweep.batch, sweep.upload,
    sweep.corrupt, sweep.fetch and sweep.collect; 8 sweep.pass a batch
    (pass_ 0-7), each with a letterbox and the predict step's three
    spans, the last three with a restoration; one sweep.score. The
    detections and summaries equal those of the same sweep with
    recording off."""
    rng = np.random.RandomState(0)
    images = {i: rng.randint(0, 256, (32, 48, 3)).astype(np.uint8)
              for i in range(3)}
    samples = [Sample(None, i, 48, 32,
                      np.array([[4.0, 4.0, 20.0, 18.0]], np.float32),
                      np.array([i % 6], np.int32)) for i in range(3)]
    (off, off_dets), _ = _sweep(samples, images, False)
    (on, on_dets), rec = _sweep(samples, images, True)
    for k in ("corrupted", "restored", "images_evaluated"):
        assert on[k] == off[k], k
    assert len(on_dets) == len(off_dets) == 16
    for a, b in zip(on_dets, off_dets):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert any(bool(d[3].any()) for d in on_dets)
    counts = rec.counts()
    assert counts == {"sweep.call": 1, "sweep.load": 2, "sweep.batch": 2,
                      "sweep.upload": 2, "sweep.corrupt": 2,
                      "sweep.pass": 16, "sweep.restore": 6,
                      "sweep.letterbox": 16, "predict.forward": 16,
                      "predict.decode": 16, "predict.nms": 16,
                      "sweep.fetch": 2, "sweep.collect": 2,
                      "sweep.score": 1}
    spans = rec.spans
    assert spans[0].name == "sweep.call" and spans[0].parent is None
    assert [s.ids["pass_"] for s in spans if s.name == "sweep.pass"] == \
        list(range(8)) * 2
    for s in spans:
        parent = spans[s.parent].name if s.parent is not None else None
        want = {"sweep.call": None, "sweep.upload": "sweep.batch",
                "sweep.corrupt": "sweep.batch", "sweep.pass": "sweep.batch",
                "sweep.restore": "sweep.pass",
                "sweep.letterbox": "sweep.pass"}.get(
            s.name, "sweep.pass" if s.name.startswith("predict.")
            else "sweep.call")
        assert parent == want, s.name
    restored = [spans[s.parent].ids["pass_"] for s in spans
                if s.name == "sweep.restore"]
    assert restored == [5, 6, 7] * 2
    assert [s.ids["batch"] for s in spans if s.name == "sweep.fetch"] == \
        [0, 1]


def test_spans_cost_little_when_off():
    """The off path is one check and a shared object: 100k spans off in
    well under a second."""
    t0 = time.perf_counter()
    for k in range(100_000):
        with P.span("x", step=k):
            pass
    assert time.perf_counter() - t0 < 1.0
