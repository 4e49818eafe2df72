"""Observability and rendering helpers."""
