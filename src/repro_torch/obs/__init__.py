"""Observability for the port; this slice carries only the clock."""
