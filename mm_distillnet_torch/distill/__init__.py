"""Distillation: pseudo-labels from the teachers and the train step."""
