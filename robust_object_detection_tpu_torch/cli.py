"""Typed CLI — one subcommand per reference entry point (counterpart of
robust_object_detection_tpu/cli.py, with its subcommands, flags and
artifacts).

``python -m robust_object_detection_tpu_torch.cli <command> [flags]``.
Every command takes ``--device`` (default: the CUDA card; a command that
computes raises where there is none unless ``--device cpu`` is given) and
``--config`` (an ExperimentConfig JSON).

Commands:
  convert-det-coco / convert-det-yolo / convert-vid-yolo
  validate                structural dataset checks
  build-testsets          the frozen corrupted testsets
  train-restoration       the U-Net
  restore-testsets        the U-Net over the testsets
  train-detector          YOLOv8 / Faster R-CNN / RT-DETR-L
  eval / eval-restored / eval-vid   the disk sweep over the testsets
  eval-fused              the on-device 4- or 8-pass sweep
  plot / plot-three / plot-vid      figures (matplotlib)
  demo                    demo strips (cv2 for the drawing)

Images are read and written through data/imageio.py: a ``.bmp`` split needs
neither PIL nor cv2. Checkpoints are the port's (``torch.save``); a
detector checkpoint loads with its EMA weights (``load_checkpoint``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ROADMAP_5C = ("Faster R-CNN trains in float32 only: its bfloat16 mode is "
              "not ported yet (ROADMAP.md §1 item 5c)")
ROADMAP_3D = ("--allow-pickle is not supported: the port reads pretrained "
              "weights with torch.load(weights_only=True) only; export the "
              "checkpoint's state_dict first (ROADMAP.md §1 item 3d, "
              "'allow_pickle')")


def _cfg(args) -> "ExperimentConfig":
    from .core import config as config_lib
    if getattr(args, "config", None):
        return config_lib.load(args.config)
    return config_lib.ExperimentConfig()


def _device(args):
    """The device a computing command runs on: --device, else the CUDA
    card (raises where there is none)."""
    from .models.layers import resolve_device
    return resolve_device(args.device)


def cmd_convert_det_coco(args):
    from .data import convert
    stats = convert.convert_det_to_coco(args.src, args.out, args.split)
    print(f"[convert-det-coco] {stats}")
    return stats


def cmd_convert_det_yolo(args):
    from .data import convert
    stats = convert.convert_det_to_yolo(args.src, args.out, args.split)
    print(f"[convert-det-yolo] {stats}")
    return stats


def cmd_convert_vid_yolo(args):
    from .data import convert
    stats = convert.convert_vid_to_yolo(args.src, args.out, args.split)
    print(f"[convert-vid-yolo] {stats}")
    return stats


def cmd_build_testsets(args):
    from .data import testsets
    cfg = _cfg(args)
    testsets.build_all(args.processed_root, args.out, cfg.corruption,
                       seed=args.seed, device=_device(args))
    manifest = testsets.testset_manifest(args.out)
    print(json.dumps(manifest, indent=2))
    return manifest


def cmd_train_restoration(args):
    from .train import restoration
    cfg = _cfg(args)
    out = restoration.train(cfg, args.train_dir, args.val_dir,
                            out_dir=args.out, max_steps=args.max_steps,
                            device=_device(args))
    print(json.dumps(out))
    return out


def cmd_restore_testsets(args):
    from .data import restore
    counts = restore.restore_testsets(args.testset_root, args.unet_dir,
                                      batch_size=args.batch_size,
                                      device=_device(args))
    print(json.dumps(counts, indent=2))
    return counts


def cmd_train_detector(args):
    cfg = _cfg(args)
    if args.allow_pickle:
        raise SystemExit(ROADMAP_3D)
    if args.model == "yolo":
        from .train import detector
        out = detector.train(cfg, args.data_root, args.out,
                             augment=args.augment, variant=args.variant,
                             epochs=args.epochs, img_size=args.img_size,
                             batch_size=args.batch_size,
                             max_steps=args.max_steps,
                             layout=args.data_layout,
                             pretrained=args.pretrained,
                             dtype=args.dtype, device=_device(args))
    elif args.model == "frcnn":
        if args.dtype == "bfloat16":
            raise SystemExit(ROADMAP_5C)
        from .train import frcnn
        out = frcnn.train(cfg, args.data_root, args.out,
                          augment=args.augment, epochs=args.epochs or 24,
                          img_size=args.img_size,
                          batch_size=args.batch_size or 2,
                          max_steps=args.max_steps,
                          pretrained=args.pretrained,
                          trainable_layers=args.trainable_layers,
                          device=_device(args))
    elif args.model == "rtdetr":
        from .train import rtdetr
        out = rtdetr.train(cfg, args.data_root, args.out,
                           augment=args.augment, epochs=args.epochs or 100,
                           img_size=args.img_size,
                           batch_size=args.batch_size or 4,
                           max_steps=args.max_steps,
                           layout=args.data_layout,
                           pretrained=args.pretrained,
                           dtype=args.dtype, device=_device(args))
    else:
        raise SystemExit(f"unknown model {args.model!r}")
    print(json.dumps(out))
    return out


def _load_models(entries, img_size, device, frcnn_native_res=False):
    """entries: list of 'name=kind:ckpt_dir' -> {name: (predict, model)}:
    each checkpoint as an eval-mode module on `device` (YOLOv8 and
    RT-DETR-L with their EMA weights), beside the port's predict step."""
    models = {}
    for e in entries:
        name, spec = e.split("=", 1)
        kind, ckpt = spec.split(":", 1)
        if kind == "yolo":
            from .train import detector
            model = detector.load_checkpoint(ckpt, device=device)
            predict = detector.make_predict_step(img_size)
        elif kind == "frcnn":
            from .eval import detector_eval
            from .train import frcnn
            model = frcnn.load_checkpoint(ckpt, device=device)
            if frcnn_native_res:
                # torchvision GeneralizedRCNNTransform parity: min800 /
                # max1333 per-image scale via static aspect buckets
                predict = detector_eval.BucketedPredict(
                    lambda b, _m=model: frcnn.make_predict_step(_m, b))
            else:
                predict = frcnn.make_predict_step(model, img_size)
        elif kind == "rtdetr":
            from .train import rtdetr
            model = rtdetr.load_checkpoint(ckpt, device=device)
            predict = rtdetr.make_predict_step(img_size)
        else:
            raise SystemExit(f"unknown model kind {kind!r}")
        models[name] = (predict, model)
    return models


def cmd_eval(args):
    from .eval import detector_eval
    models = _load_models(args.model, args.img_size, _device(args),
                          getattr(args, "frcnn_native_res", False))
    return detector_eval.sweep(models, args.testset_root, args.img_size,
                               args.batch_size, args.out, layout=args.layout,
                               results_name=args.results_name)


def cmd_eval_fused(args):
    """Fused on-device sweep: corrupt -> restore -> detect chained per
    batch on the device (eval/fused_sweep.py). Takes the CLEAN val split —
    the corrupted variants are made on the device — and writes the same
    8-pass (4 variants x {corrupted, restored}) summaries as the disk
    sweep. The disk path (build-testsets / restore-testsets / eval)
    remains the frozen-testset parity path."""
    from .core import artifacts
    from .data import pipeline as pipe
    from .eval import fused_sweep
    from .eval.detector_eval import BucketedPredict
    device = _device(args)
    models = _load_models(args.model, args.img_size, device)
    unet_model = None
    if args.unet_dir:
        from .train.restoration import load_best
        unet_model = load_best(args.unet_dir, device=device)
    samples = pipe.index_coco(args.data_root, args.split)
    results = {}
    rows = []
    parity = args.mt19937_parity
    for name, (predict, model) in models.items():
        if isinstance(predict, BucketedPredict):
            raise SystemExit("--frcnn-native-res is not supported in the "
                             "fused sweep (single-canvas letterbox path)")
        rng = None
        if parity != "off":
            # coco6 draws come AFTER the yolo6 layout's (same val images);
            # see fused_sweep.frozen_noise_rng
            rng = fused_sweep.frozen_noise_rng(
                skip_splits=([samples] if parity == "coco6" else []))
        out = fused_sweep.run_fused_sweep(
            predict, model, unet_model, None, samples, args.img_size,
            args.batch_size, mt19937_rng=rng)
        results[name] = out
        for strategy in fused_sweep.STRATEGIES:
            if strategy not in out:
                continue
            for variant, s in out[strategy].items():
                rows.append([name, strategy, variant,
                             round(s["mAP50"], 4), round(s["mAP50_95"], 4),
                             out["images_per_sec"]])
    artifacts.write_json(Path(args.out) / "fused_eval_results.json", results)
    print(artifacts.format_table(
        ["model", "strategy", "testset", "mAP50", "mAP50_95",
         "sweep img/s"], rows))
    return results


def _count_images(d: Path) -> int:
    from .data import imageio
    return sum(1 for p in d.glob("*.*")
               if p.suffix.lower() in imageio.IMAGE_EXTS)


def cmd_validate(args):
    """Structural dataset checks (the converters' layouts; images of every
    suffix data/imageio.py reads are counted)."""
    root = Path(args.root)
    problems = []
    if args.kind == "visdrone-det":
        for sub in ("images", "annotations"):
            if not (root / sub).is_dir():
                problems.append(f"missing {root / sub}")
        n_img = _count_images(root / "images")
        n_ann = len(list((root / "annotations").glob("*.txt")))
        print(f"[validate] images={n_img} annotations={n_ann}")
        if n_img == 0:
            problems.append("no images")
    elif args.kind == "coco":
        ann = root / "annotations" / f"instances_{args.split}.json"
        if not ann.exists():
            problems.append(f"missing {ann}")
        else:
            from .data.convert import load_coco
            idx = load_coco(ann)
            n_missing = sum(
                1 for im in idx["images"].values()
                if not (root / "images" / args.split /
                        im["file_name"]).exists())
            n_boxes = sum(len(v) for v in idx["anns_by_image"].values())
            print(f"[validate] images={len(idx['images'])} "
                  f"annotations={n_boxes} missing_files={n_missing}")
            if n_missing:
                problems.append(f"{n_missing} image files missing")
    else:   # yolo
        n_img = _count_images(root / "images" / args.split)
        n_lbl = len(list((root / "labels" / args.split).glob("*.txt")))
        print(f"[validate] images={n_img} labels={n_lbl}")
        if not (root / "data.yaml").exists():
            problems.append("missing data.yaml")
    if problems:
        raise SystemExit("[validate] FAILED: " + "; ".join(problems))
    print("[validate] OK")
    return True


def cmd_eval_restored(args):
    """Baseline checkpoints swept over the U-Net-restored testsets
    (``<layout>_restored`` roots, eval_restored_results.json)."""
    args.layout = (args.layout if args.layout.endswith("_restored")
                   else args.layout + "_restored")
    args.results_name = "eval_restored_results"
    return cmd_eval(args)


def cmd_eval_vid(args):
    """VID checkpoints evaluated on the DET testsets
    (vid_eval_results.json)."""
    args.results_name = "vid_eval_results"
    return cmd_eval(args)


def cmd_demo(args):
    from .data import pipeline
    from .report import demo
    models = _load_models([f"base={args.base}", f"aug={args.aug}"],
                          args.img_size, _device(args))
    samples = pipeline.index_coco(args.data_root, "val")
    (pb, sb), (pa, sa) = models["base"], models["aug"]
    paths = demo.run_demo(samples, pb, pa, sb, sa, args.out, args.img_size,
                          args.name, n_images=args.n)
    print("\n".join(str(p) for p in paths))
    return paths


def cmd_plot(args):
    from .core import artifacts
    from .report import plots
    results = artifacts.read_json(args.results)
    paths = plots.det_figure_suite(results, args.out, prefix=args.prefix)
    print("\n".join(str(p) for p in paths))
    return paths


def cmd_plot_three(args):
    from .core import artifacts
    from .report import plots
    results = artifacts.read_json(args.results)
    restored = artifacts.read_json(args.restored)
    paths = plots.three_strategy_suite(results, restored, args.out)
    print("\n".join(str(p) for p in paths))
    return paths


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="robust_object_detection_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn, *specs):
        sp = sub.add_parser(name)
        for flags, kw in specs:
            sp.add_argument(*flags, **kw)
        sp.add_argument("--config", default=None,
                        help="ExperimentConfig JSON")
        sp.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "to run on the host)")
        sp.set_defaults(fn=fn)
        return sp

    for cname, fn in (("convert-det-coco", cmd_convert_det_coco),
                      ("convert-det-yolo", cmd_convert_det_yolo),
                      ("convert-vid-yolo", cmd_convert_vid_yolo)):
        add(cname, fn,
            (("--src",), {"required": True}),
            (("--out",), {"required": True}),
            (("--split",), {"default": "val"}))

    add("build-testsets", cmd_build_testsets,
        (("--processed-root",), {"required": True}),
        (("--out",), {"required": True}),
        (("--seed",), {"type": int, "default": 42}))

    add("train-restoration", cmd_train_restoration,
        (("--train-dir",), {"required": True}),
        (("--val-dir",), {"required": True}),
        (("--out",), {"required": True}),
        (("--max-steps",), {"type": int, "default": None}))

    add("restore-testsets", cmd_restore_testsets,
        (("--testset-root",), {"required": True}),
        (("--unet-dir",), {"required": True}),
        (("--batch-size",), {"type": int, "default": 8}))

    add("train-detector", cmd_train_detector,
        (("--model",), {"required": True,
                        "choices": ["yolo", "frcnn", "rtdetr"]}),
        (("--data-root",), {"required": True}),
        (("--out",), {"required": True}),
        (("--augment",), {"action": "store_true"}),
        (("--variant",), {"default": "m"}),
        (("--epochs",), {"type": int, "default": None}),
        (("--img-size",), {"type": int, "default": 1024}),
        (("--batch-size",), {"type": int, "default": None}),
        (("--max-steps",), {"type": int, "default": None}),
        (("--data-layout",), {"default": "coco",
                              "choices": ["coco", "yolo"],
                              "help": "yolo = VID-flattened layout"}),
        (("--pretrained",), {"default": None,
                             "help": "state_dict file to import "
                                     "(Ultralytics / torchvision layout)"}),
        (("--allow-pickle",), {"action": "store_true",
                               "help": "not supported: pretrained weights "
                                       "are read with weights_only=True"}),
        (("--dtype",), {"default": None,
                        "choices": ["bfloat16", "float32"],
                        "help": "compute dtype (default: bfloat16 on the "
                                "card, float32 elsewhere; Faster R-CNN: "
                                "float32 only)"}),
        (("--trainable-layers",), {"type": int, "default": None,
                                   "help": "FRCNN only: torchvision "
                                           "trainable_backbone_layers "
                                           "0..5 (default 3 when "
                                           "--pretrained, else 5)"}))

    native_res = (("--frcnn-native-res",),
                  {"action": "store_true",
                   "help": "evaluate FRCNN at torchvision min800/max1333 "
                           "native scale via static aspect buckets"})
    add("eval", cmd_eval,
        (("--model",), {"action": "append", "required": True,
                        "help": "name=kind:ckpt_dir (repeatable)"}),
        native_res,
        (("--testset-root",), {"required": True}),
        (("--img-size",), {"type": int, "default": 1024}),
        (("--batch-size",), {"type": int, "default": 8}),
        (("--layout",), {"default": "coco6"}),
        (("--results-name",), {"default": "eval_results"}),
        (("--out",), {"default": "experiments"}))

    add("eval-fused", cmd_eval_fused,
        (("--model",), {"action": "append", "required": True,
                        "help": "name=kind:ckpt_dir (repeatable)"}),
        (("--data-root",), {"required": True,
                            "help": "COCO-layout CLEAN val split (e.g. "
                                    "processed/visdrone_coco6) — variants "
                                    "are generated on the device"}),
        (("--split",), {"default": "val"}),
        (("--unet-dir",), {"default": None,
                           "help": "restoration run dir; omit to skip "
                                   "the restored stream (4 passes)"}),
        (("--img-size",), {"type": int, "default": 1024}),
        (("--batch-size",), {"type": int, "default": 8}),
        (("--mt19937-parity",), {"default": "off",
                                 "choices": ["off", "yolo6", "coco6"],
                                 "help": "replay the frozen MT19937 noise "
                                         "stream (host-drawn planes) for "
                                         "this layout instead of the "
                                         "device generator — bit parity "
                                         "with the disk testsets on "
                                         "lossless sources"}),
        (("--out",), {"default": "experiments"}))

    add("validate", cmd_validate,
        (("--root",), {"required": True}),
        (("--kind",), {"default": "coco",
                       "choices": ["visdrone-det", "coco", "yolo"]}),
        (("--split",), {"default": "val"}))

    add("eval-restored", cmd_eval_restored,
        (("--model",), {"action": "append", "required": True,
                        "help": "name=kind:ckpt_dir (repeatable)"}),
        native_res,
        (("--testset-root",), {"required": True}),
        (("--img-size",), {"type": int, "default": 1024}),
        (("--batch-size",), {"type": int, "default": 8}),
        (("--layout",), {"default": "coco6",
                         "help": "'_restored' suffix added if absent"}),
        (("--out",), {"default": "experiments"}))

    add("eval-vid", cmd_eval_vid,
        (("--model",), {"action": "append", "required": True}),
        native_res,
        (("--testset-root",), {"required": True}),
        (("--img-size",), {"type": int, "default": 1024}),
        (("--batch-size",), {"type": int, "default": 8}),
        (("--layout",), {"default": "coco6"}),
        (("--out",), {"default": "experiments"}))

    add("demo", cmd_demo,
        (("--base",), {"required": True, "help": "kind:ckpt_dir"}),
        (("--aug",), {"required": True, "help": "kind:ckpt_dir"}),
        (("--data-root",), {"required": True}),
        (("--img-size",), {"type": int, "default": 1024}),
        (("--name",), {"default": "model"}),
        (("--n",), {"type": int, "default": 5}),
        (("--out",), {"default": "experiments/demo"}))

    add("plot", cmd_plot,
        (("--results",), {"required": True}),
        (("--out",), {"default": "experiments/figures"}),
        (("--prefix",), {"default": ""}))

    add("plot-three", cmd_plot_three,
        (("--results",), {"required": True}),
        (("--restored",), {"required": True}),
        (("--out",), {"default": "experiments/figures"}))

    # plot-vid = the DET figure suite over vid_eval_results.json with the
    # vid_ filename prefix
    add("plot-vid", cmd_plot,
        (("--results",), {"required": True}),
        (("--out",), {"default": "experiments/figures"}),
        (("--prefix",), {"default": "vid_"}))
    return p


def main(argv=None):
    """Parse `argv` (None: sys.argv), join the process group the
    environment names, run the command; returns what the command
    returns."""
    args = build_parser().parse_args(argv)
    # multi-process entry: env-driven torch.distributed (a no-op without
    # the variables) before the command touches a device
    from .parallel import distributed
    distributed.maybe_initialize(args.device)
    return args.fn(args)


if __name__ == "__main__":
    main()
