"""Datasets and the input pipeline (numpy only)."""
