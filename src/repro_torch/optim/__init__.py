"""Optimizers as plain functions over dicts of tensors."""
