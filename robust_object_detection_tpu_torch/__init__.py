"""robust_object_detection_tpu_torch — the PyTorch + CUDA port.

The JAX package ``robust_object_detection_tpu`` is the reference; this
package reproduces its robustness-evaluation path (corrupt -> letterbox ->
YOLOv8 -> multi-label NMS -> COCO mAP) in PyTorch, with the Pallas kernels
of that path rewritten as CUDA C++ for Hopper (``csrc/``, built and bound by
``kernels/``). It imports ``torch`` and never ``jax``; the only code it
shares with the reference is the jax-free host side
(``eval.coco_map``, ``data.pipeline``, ``data.visdrone``,
``data.synthetic``).

Layout mirrors the reference: ``core/`` (config), ``ops/`` (image,
corruption, the kernel wrappers, NMS), ``models/`` (YOLOv8 + weight
conversion), ``train/`` (the predict step), ``eval/`` (the fused sweep).
"""

__version__ = "0.1.0"
