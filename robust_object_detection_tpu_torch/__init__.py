"""robust_object_detection_tpu_torch — the PyTorch + CUDA port.

The JAX package ``robust_object_detection_tpu`` is the reference; this
package reproduces, in PyTorch, its robustness-evaluation path (corrupt ->
[restore ->] letterbox -> detector -> decode -> COCO mAP) for YOLOv8
(multi-label NMS) and RT-DETR-L (NMS-free top-k), with the restoration
U-Net's Restored strategy (the 8-pass sweep, the frozen testsets and their
restoration, the U-Net trainer), and the YOLOv8 and RT-DETR-L train steps,
with the Pallas kernels of those paths rewritten as CUDA C++ for Hopper
(``csrc/``, built and bound by ``kernels/``). It imports ``torch`` and
never ``jax``, and nothing of the reference package: the host code it needs
(``core``'s config, artifacts, checkpoints and profiling, ``eval.coco_map``,
``native``, ``data.pipeline.Sample`` / ``load_image_rgb``,
``data.visdrone``'s class tables) is its own copy.

Layout mirrors the reference: ``core/`` (config, artifacts, checkpoints,
profiling), ``ops/`` (image, corruption, SSIM, the kernel wrappers, NMS),
``models/`` (YOLOv8, RT-DETR-L, the U-Net and weight conversion),
``train/`` (train and predict steps, the U-Net trainer), ``eval/`` (the
fused sweep and the scorer), ``native/`` (the scorer's C++ matcher),
``data/`` (sample record, class tables, frozen testsets, restoration).

Entry points (``models.*.create`` and what builds on them) put a model on
the CUDA card unless the caller names another device; without a card they
raise.
"""

__version__ = "0.1.0"
