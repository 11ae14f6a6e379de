"""Model-FLOP utilisation for the port.

MFU = achieved model FLOP/s / the card's peak dense FLOP/s. The numerator is
the PaLM appendix-B accounting of the JAX package (:func:`model_flops_per_token`,
unchanged); the denominator comes from this package's own table of NVIDIA
cards. An unknown card is an error, not a guessed peak.
"""

from __future__ import annotations

from typing import Dict

#: Peak dense bf16 FLOP/s per card, by lower-case substring of
#: ``torch.cuda.get_device_name()``: NVIDIA's data sheets, SXM parts, at their
#: full 700 W power limit.
PEAK_FLOPS: Dict[str, float] = {
    "h100": 989e12,
}


def peak_flops_per_chip(device_kind: str) -> float:
    kind = (device_kind or "").lower()
    if "pcie" not in kind and " nvl" not in kind:  # other parts, other peaks
        for key, val in PEAK_FLOPS.items():
            if key in kind:
                return val
    raise KeyError(f"no peak FLOP/s known for device {device_kind!r}; "
                   f"known: {sorted(PEAK_FLOPS)} (SXM parts)")


def model_flops_per_token(n_params: int, n_layers: int, d_model: int,
                          seq_len: int) -> float:
    """Training FLOPs per token: 6N for the parameter matmuls (fwd+bwd)
    plus 12·L·d·s for the attention score/context matmuls (PaLM appendix B
    accounting — the standard MFU numerator)."""
    return 6.0 * n_params + 12.0 * n_layers * d_model * seq_len


def mfu(achieved_flops_per_sec: float, n_chips: int, device_kind: str) -> float:
    """MFU: achieved model FLOP/s over ``n_chips`` x peak."""
    return achieved_flops_per_sec / (max(n_chips, 1) * peak_flops_per_chip(device_kind))
