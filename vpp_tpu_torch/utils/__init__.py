"""Helpers that need no device: synthetic clips."""
