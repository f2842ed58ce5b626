"""Synthetic training batches."""
