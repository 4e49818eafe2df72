"""Keypoint export helpers."""
