"""Elastic-runtime roles of the PyTorch port (so far the evaluator pod)."""
