"""Deterministic token streams and their background prefetch."""
