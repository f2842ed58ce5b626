"""Configs, weight conversion and the model factory."""
