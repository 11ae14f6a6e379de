"""Training core of the PyTorch port: data, trainer, metrics, MFU."""
