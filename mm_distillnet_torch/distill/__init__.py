"""Distillation: pseudo-labels from the teachers (the train step waits for the training slice)."""
