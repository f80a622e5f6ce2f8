"""Prefill, decode and greedy generation (``serve/`` of the reference)."""
