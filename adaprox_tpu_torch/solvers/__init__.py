"""Stepsize rules, shared solver types and the proximal-gradient engine."""
