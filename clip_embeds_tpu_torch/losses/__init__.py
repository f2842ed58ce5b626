"""Contrastive losses."""
