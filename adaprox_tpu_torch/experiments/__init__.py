"""Experiment drivers (the lasso driver so far)."""
