"""EfficientDet model family and the fused eval forward (NHWC at the boundary)."""
