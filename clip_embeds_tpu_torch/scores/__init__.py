"""Scorers over the port's models for the eval drivers, and the m x n
Score API."""
