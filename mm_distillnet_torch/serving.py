"""Serving surface (port of mm_distillnet_tpu/serving.py): a weight-baked
predictor, its export to a file that replays without the model code, and
fixed-batch micro-batching.

`make_serving_fn` folds the weights once and returns images (B, H, W, C)
-> Detections: the fused forward (MBConv blocks as CUDA kernels by
default, models/fused_forward.py) then decode + packed top-k + per-class
NMS (ops/postprocess.py); with a `quant_pack` (quant.py) the unfused
module tree runs the int8 path instead. `serve_many` chunks any number of
images into the predictor's batch, zero-pads the tail and returns the
real rows.

On a card the predictor replays that device work as a CUDA graph, one a
key (the input's shape and dtype once on the card): the first call of a
key runs the sequence once on a side stream (builds, library handles, the
device caches of ops/resize.py and ops/anchors.py) and captures it; every
call copies its input into the graph's static buffer, replays, and
returns clones of the graph's outputs, so a caller may keep every call's
Detections and reuse its input at once. On the CPU, while torch.export
traces and inside a caller's own capture the sequence runs as it is.

A compact-audio batch (80 mel rows instead of `image_size`) is stretched
on the device first (ops/resize.py); any other height raises. With a
`mesh` (parallel.mesh.create_mesh: a tuple of devices) the predictor
keeps one replica per device, pads the batch to the mesh, runs a part on
each device and returns the real rows on the first (the JAX package's
batch-sharded serving over a `data` mesh).

`export_predictor` traces a predictor at one fixed input shape with
torch.export (the MBConv kernels are the custom ops
`mm_distillnet::mbconv_*`, ops/fused_mbconv.py; the weights are constants
of the program) and saves it as a .pt2 file; `load_predictor` replays it
in any process that has torch and this package's ops, without building a
model. It is the counterpart of the JAX package's `jax.export` StableHLO
artifact.
"""
from __future__ import annotations

import functools
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .models.fused_forward import eval_module, make_fused_predictor
from .ops import fused_mbconv  # noqa: F401  (registers the custom ops)
from .ops.anchors import anchor_table
from .ops.postprocess import (Detections, class_validity_table,
                              postprocess_detections)
from .ops.resize import maybe_stretch_mel_axis
from .parallel.mesh import over_mesh
from .quant import pack_to, quantized_apply
from .utils.profiling import span

__all__ = ['make_serving_fn', 'export_predictor', 'load_predictor',
           'serve_many']


def make_serving_fn(model, state_dict, image_size: int, *,
                    conf_threshold: float = 0.3,
                    nms_threshold: float = 0.5,
                    num_candidates: int = 512,
                    max_detections: int = 100,
                    approx: bool = False,
                    valid_prediction_ids: Optional[Sequence[int]] = None,
                    num_classes: int = 20,
                    plan_spec: Optional[str] = None,
                    dtype: torch.dtype = torch.bfloat16,
                    mesh=None,
                    quant_pack=None,
                    device='cuda') -> Callable[..., Detections]:
    """Predictor images (B, H, W, C) -> Detections on `device`.

    Thresholds are the shipped eval defaults (reference
    configs/mm-distillnet.cfg:117-119); valid_prediction_ids defaults to
    [6] ('car'). `plan_spec` and `dtype` go to make_fused_predictor.
    `approx` is the JAX package's switch to `approx_max_k`, exact off the
    TPU, so both values select the same candidates. With `quant_pack`
    (quant.build_quant_pack) a copy of `model` in `dtype` runs the int8
    path (quant.quantized_apply) and no MBConv kernel runs. With `mesh` (a
    tuple of devices; `device` is then not read) any batch is split over
    one replica per device and the Detections come back on mesh[0]."""
    replica = functools.partial(
        _replica, model, state_dict, image_size, conf_threshold,
        nms_threshold, num_candidates, max_detections, approx,
        valid_prediction_ids, num_classes, plan_spec, dtype, quant_pack)
    if mesh is None:
        one = replica(device)
        predict = _Predictor(one, [one])
        predict.forward = one.forward
        predict.run = one.run
        predict.device = one.device
        return predict
    replicas = [replica(d) for d in mesh]
    return _Predictor(over_mesh(mesh, replicas), replicas)


class _Predictor:
    """make_serving_fn's predictor: `call` under the `mmd.serve` span.
    `captures` and `replays` sum its replicas' CUDA graphs' (0 on the
    CPU). Without a mesh it also carries its replica's `forward` (the
    eager forward), `run` (the eager call on a tensor on the device) and
    `device`."""

    def __init__(self, call, replicas):
        self._call = call
        self.replicas = replicas

    def __call__(self, x) -> Detections:
        with span('mmd.serve'):
            return self._call(x)

    @property
    def captures(self) -> int:
        return sum(r.graphs.captures for r in self.replicas)

    @property
    def replays(self) -> int:
        return sum(r.graphs.replays for r in self.replicas)


def _replica(model, state_dict, image_size, conf_threshold, nms_threshold,
             num_candidates, max_detections, approx, valid_prediction_ids,
             num_classes, plan_spec, dtype, quant_pack, device):
    """make_serving_fn's predictor on one device, under no span of its
    own: the caller's `mmd.serve` covers a mesh's replicas at once."""
    dev = resolve_device(device)
    if quant_pack is not None:
        net = eval_module(model, state_dict, dev, dtype)
        pack = pack_to(quant_pack, dev)

        def forward(x):
            return quantized_apply(net, pack, x)
    else:
        forward = make_fused_predictor(model, state_dict, image_size,
                                       plan_spec=plan_spec, dtype=dtype,
                                       device=dev)
    anchors = torch.as_tensor(anchor_table(image_size), device=dev)
    if valid_prediction_ids is None:
        valid_prediction_ids = [6]  # 'car', the shipped target class
    class_valid = torch.as_tensor(
        class_validity_table(num_classes, list(valid_prediction_ids)),
        device=dev)

    @torch.no_grad()
    def run(x: torch.Tensor) -> Detections:
        out = forward(maybe_stretch_mel_axis(x, image_size))
        with span('mmd.postprocess'):
            return postprocess_detections(
                out.classification, out.regression, anchors, class_valid,
                image_size=image_size, conf_threshold=conf_threshold,
                nms_threshold=nms_threshold, num_candidates=num_candidates,
                max_detections=max_detections, approx=approx)

    graphs = _Graphs(run, dev)

    @torch.no_grad()
    def predict(x) -> Detections:
        x = torch.as_tensor(x, device=dev)
        if dev.type != 'cuda' or torch.compiler.is_exporting() or \
                torch.cuda.is_current_stream_capturing():
            return run(x)
        return graphs(x)

    predict.forward = forward
    predict.run = run
    predict.graphs = graphs
    predict.device = dev
    return predict


class _Graphs:
    """`run` on one card as a CUDA graph a key (shape, dtype): captured at
    the key's first call, replayed at every call (that one too). Each new
    key costs an eager pass and a capture, and its graph is kept. All the
    graphs allocate from one memory pool: a lock, held from the copy in
    to the clones out, lets one replay run at a time. A capture that
    fails raises. The kernels' own counters count what their wrappers
    launch: the eager pass and the capture, not a replay."""

    def __init__(self, run: Callable[[torch.Tensor], Detections],
                 dev: torch.device):
        self.run = run
        self.dev = dev
        self.graphs: dict = {}
        self.captures = 0
        self.replays = 0
        self._pool = None
        self._lock = threading.Lock()

    def __call__(self, x: torch.Tensor) -> Detections:
        with self._lock, torch.cuda.device(self.dev):
            key = (tuple(x.shape), x.dtype)
            if key not in self.graphs:
                self.graphs[key] = self._capture(x)
            graph, static_x, static_out = self.graphs[key]
            static_x.copy_(x)
            with span('mmd.graph_replay'):
                graph.replay()
            self.replays += 1
            return Detections(*(t.clone() for t in static_out))

    def _capture(self, x: torch.Tensor):
        """The graph of `run` on a static copy of x, and its outputs."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static_x = x.clone(memory_format=torch.contiguous_format)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            self.run(static_x)
        torch.cuda.current_stream(self.dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=side):
            static_out = self.run(static_x)
        self.captures += 1
        return graph, static_x, static_out


class _Exported(torch.nn.Module):
    """A predictor as a module: images -> the Detections' four tensors."""

    def __init__(self, predict):
        super().__init__()
        self.predict = predict

    def forward(self, x: torch.Tensor):
        return tuple(self.predict(x))


def export_predictor(predict_fn, batch_size: int, image_size: int,
                     channels: int, path: str, *,
                     platforms: Optional[Sequence[str]] = None) -> None:
    """Export `predict_fn` (from make_serving_fn, weights baked) at the
    input (batch_size, image_size, image_size, channels) fp32 with
    torch.export, and save the program to `path` (.pt2).

    `platforms` None keeps the predictor's own device; ('cpu',) or
    ('cuda',) moves the program's constants and devices there, and the
    custom ops then run that device's implementation. A TPU is not a
    platform of this package."""
    target = None
    if platforms is not None:
        platforms = list(platforms)
        if platforms not in (['cpu'], ['cuda']):
            raise ValueError(f'platforms {platforms}: the port exports for '
                             "one of ('cpu',) or ('cuda',)")
        target = resolve_device(platforms[0])
    x = torch.zeros((batch_size, image_size, image_size, channels),
                    dtype=torch.float32, device=predict_fn.device)
    with torch.no_grad():
        program = torch.export.export(_Exported(predict_fn), (x,),
                                      strict=False)
    if target is not None and target != predict_fn.device:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, target)
    program.example_inputs = None   # the traced batch, not the program
    torch.export.save(program, path)


def load_predictor(path: str, device='cuda') -> Callable[..., Detections]:
    """Load an export_predictor file; returns images -> Detections on
    `device` (the program is moved there if it was exported for another
    device)."""
    dev = resolve_device(device)
    program = torch.export.load(path)
    from torch.export.passes import move_to_device_pass
    module = move_to_device_pass(program, dev).module()

    @torch.no_grad()
    def predict(x) -> Detections:
        return Detections(*module(torch.as_tensor(x, device=dev)))

    predict.device = dev
    return predict


def serve_many(predict_fn, images: np.ndarray,
               batch_size: int) -> Detections:
    """Run any number of images through a fixed-batch predictor: chunk to
    `batch_size`, zero-pad the tail chunk, concatenate the real rows back
    out (numpy arrays)."""
    n = images.shape[0]
    outs = []
    for start in range(0, n, batch_size):
        chunk = images[start:start + batch_size]
        real = chunk.shape[0]
        if real < batch_size:
            pad = np.zeros((batch_size - real,) + chunk.shape[1:],
                           chunk.dtype)
            chunk = np.concatenate([chunk, pad], axis=0)
        dets = predict_fn(chunk)
        outs.append([t[:real].cpu().numpy() for t in dets])
    return Detections(*(np.concatenate([o[i] for o in outs], axis=0)
                        for i in range(len(Detections._fields))))
