"""Multi-process scaffolding (counterpart of robust_object_detection_tpu/
parallel/): env-driven ``torch.distributed``, per-process data, and the
(data, model) mesh over the process group."""
