"""Evaluation metrics: numpy post-processing of saved results."""
