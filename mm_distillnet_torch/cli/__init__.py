"""The port's command-line entry points: `python -m
mm_distillnet_torch.cli.train`, `...cli.evaluate` and `...cli.mp3_to_pkl`,
with the root CLIs' flags and `--device` (default cuda)."""
