"""Models of the PyTorch port (GPT on the shared transformer stack)."""
