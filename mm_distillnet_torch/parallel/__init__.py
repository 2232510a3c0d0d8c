"""Multi-process runs (port of mm_distillnet_tpu/parallel/)."""
