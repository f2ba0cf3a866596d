"""What the reference forwards share: the norm, rotary embedding, and
the products, exact in float32 or, for the lower-precision control, with
both operands rounded to float8 (e4m3) first."""
from __future__ import annotations

import torch

FP8_MAX = 448.0                       # largest finite float8_e4m3fn


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + w), the models' norm."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale a slice along ``dim``
    (its largest magnitude maps to 448), returned in float32."""
    scale = torch.amax(t.abs(), dim=dim, keepdim=True).clamp(min=1e-30) \
        / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str = "f32"
       ) -> torch.Tensor:
    """``x @ w`` in float32; with ``precision="fp8"`` both operands rounded
    to float8 first (x a row at a time, w an output column at a time),
    the product accumulated in float32."""
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w, -2)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding over the whole head, halves rotated (not
    interleaved). x: (N, T, H, hd); positions: (T,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
