"""Training orchestration: optimizers and schedulers, checkpoints, the
trainer."""
