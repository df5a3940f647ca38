"""Evaluation-time mask helpers (the training port comes later)."""
