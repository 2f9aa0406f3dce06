"""Objectives and problem generators."""
