"""Synthetic data generators (numpy)."""
