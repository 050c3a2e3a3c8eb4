"""Multi-process scaffolding (counterpart of robust_object_detection_tpu/
parallel/): env-driven ``torch.distributed`` and per-process data."""
