"""Faults planted underneath the timed path, to show that the check
catches them (benchmark/tests/test_bench_faults.py at a small size on the
CPU, control.py at the cells' size on the card). No benchmark run uses
them.

A serve fault wraps the predictor; a train fault wraps the step (and may
patch the step's module, `ts`, for as long as the process lives).
"""
from __future__ import annotations

import torch


# ------------------------------------------------------------------ serve

def serve_half_batch(predict):
    """Only the first half of each batch is served; the other rows come
    back empty."""
    def broken(x):
        dets = predict(x)
        half = -(-x.shape[0] // 2)
        valid = dets.valid.clone()
        valid[half:] = False
        return type(dets)(dets.boxes, dets.scores, dets.classes, valid)
    return broken


def serve_altered(predict):
    """Each frame's best detection comes back with half its score."""
    def broken(x):
        dets = predict(x)
        scores = dets.scores.clone()
        scores[:, 0] *= 0.5
        return type(dets)(dets.boxes, scores, dets.classes, dets.valid)
    return broken


def serve_stale(predict):
    """Each call returns the previous call's detections."""
    last = []

    def broken(x):
        dets = predict(x)
        out = last[0] if last else dets
        last[:] = [dets]
        return out
    return broken


def serve_one_slot(predict):
    """The last frame of each batch comes back with the first frame's
    detections (a batch of one is left as it is)."""
    def broken(x):
        dets = predict(x)
        fields = [f.clone() for f in (dets.boxes, dets.scores,
                                       dets.classes, dets.valid)]
        for f in fields:
            f[-1] = f[0]
        return type(dets)(*fields)
    return broken


# ------------------------------------------------------------------ train

def train_unchanged(step, ts):
    """The step runs but leaves the parameters and the optimizer as they
    were."""
    def broken(state, batch):
        params = [p.detach().clone() for p in state.model.parameters()]
        opt = state.optimizer.state_dict()
        metrics = step(state, batch)
        with torch.no_grad():
            for p, q in zip(state.model.parameters(), params):
                p.copy_(q)
        state.optimizer.load_state_dict(opt)
        state.optimizer.state.clear()
        return metrics
    return broken


def train_half_batch(step, ts):
    """The step sees only the first half of the batch: its losses are the
    mean over those frames."""
    def broken(state, batch):
        half = -(-next(iter(batch.values())).shape[0] // 2)
        return step(state, {k: v[:half] for k, v in batch.items()})
    return broken


def train_altered(step, ts):
    """The fused pseudo-labels come out with the first frame's first box
    moved by 64 px."""
    fuse = ts.fuse_teacher_labels

    def altered(per_teacher, cfg):
        out = fuse(per_teacher, cfg).clone()
        out[0, 0, :4] += 64.0
        return out
    ts.fuse_teacher_labels = altered
    return step


SERVE = {'half_batch': serve_half_batch, 'altered': serve_altered,
         'stale': serve_stale, 'one_slot': serve_one_slot}
TRAIN = {'unchanged': train_unchanged, 'half_batch': train_half_batch,
         'altered': train_altered}
