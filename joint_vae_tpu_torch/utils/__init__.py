"""Utilities: signal-aware stopping and live epoch output."""
