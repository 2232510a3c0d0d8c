"""Datasets and the input pipeline (numpy and the port's host C++
image decoder, csrc/image_decode.cpp; no cv2)."""
