"""Evaluation: checkpoint loading and model analysis, metrics, comparison reports."""
