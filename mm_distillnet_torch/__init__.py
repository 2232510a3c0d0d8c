"""PyTorch/CUDA port of mm_distillnet_tpu for NVIDIA Hopper (H100).

The JAX package `mm_distillnet_tpu` is the reference; this package imports
nothing of it (nor of JAX). Public functions keep the reference's NHWC
layout at their boundary. Entry points take `device=` (default 'cuda') and
raise when CUDA is absent unless the caller asked for the CPU.

Ported so far: the student's serving path — the EfficientDet forward
(`models/`), the fused eval backbone whose MBConv blocks run as hand-written
CUDA kernels (`models/fused_forward.py`, `ops/fused_mbconv.py`,
`csrc/mbconv.cu`), decode + packed top-k + per-class NMS (`ops/`) and
`serving.make_serving_fn` / `serve_many`; and the teacher half of
distillation with the whole of evaluation: the compact-audio stretch
(`ops/resize.py`), the teachers' eval forwards through the same kernels and
their fusion into pseudo-labels (`distill/pseudo_labels.py`,
`evaluation.make_fused_teacher_fn`), the config, the synthetic dataset and
loader (`config.py`, `data/`), the metrics (`utils/metrics.py`) and
`evaluation.evaluate`; and training: the losses (`losses/`), the
distillation step with the teachers on the same kernels
(`distill/train_step.py`), optimizers and schedulers (`train/optim.py`),
checkpoints (`train/checkpoint.py`), run logging (`utils/`) and
`train.trainer.train`; and the system's entry points: the CLIs
(`python -m mm_distillnet_torch.cli.train`, `...cli.evaluate`,
`...cli.mp3_to_pkl`), the model registry with reference `.pth` loading
(`models/registry.py`, `convert/weights.py`), the multi-modal generator
and StereoSoundNet (`models/`), the dataset factory (`data/factory.py`),
the log-mel frontend (`ops/audio.py`) and BN recalibration
(`train/bn_recalibration.py`).
"""
