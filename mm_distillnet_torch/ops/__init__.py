"""Anchors, boxes, NMS, post-processing and the fused MBConv kernels."""
