"""Detection and distillation losses (port of mm_distillnet_tpu/losses)."""
