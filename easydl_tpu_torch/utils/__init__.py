"""Logging and device selection for the PyTorch port."""
