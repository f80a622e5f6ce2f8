"""Launchers of the port (``launch/`` of the reference)."""
