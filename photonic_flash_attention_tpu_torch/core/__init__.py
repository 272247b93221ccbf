"""Serving core: request scheduler and the continuous-batching engine."""
