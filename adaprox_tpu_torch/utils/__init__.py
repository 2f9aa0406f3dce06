"""Telemetry (numpy-only JSONL writer) and timing on the card."""
