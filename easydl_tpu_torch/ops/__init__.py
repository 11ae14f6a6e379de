"""Attention ops of the PyTorch port: the flash kernels and the reference."""

from easydl_tpu_torch.ops.attention import multihead_attention, reference_attention

__all__ = ["multihead_attention", "reference_attention"]
