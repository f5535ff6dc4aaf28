"""Evaluation of trained vectors (the Google analogy task)."""
