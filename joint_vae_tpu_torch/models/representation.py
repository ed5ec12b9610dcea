"""Color-space representation (ref Rgb2hsv, module/vae_layers/layers.py:11-70).

Port of ``rgb2hsv`` from ``joint_vae_tpu/models/representation.py``,
used by ``CVNet.features`` when the config sets representation='hsv'."""

import torch


def rgb2hsv(x: torch.Tensor, epsilon: float = 1e-10,
            hmax: float = 1.0) -> torch.Tensor:
    """(..., 3, H, W) RGB in [0, 1] -> HSV."""
    r, g, b = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    max_rgb = torch.amax(x, dim=-3)
    min_rgb = torch.amin(x, dim=-3)
    argmin = torch.argmin(x, dim=-3)
    max_min = max_rgb - min_rgb + epsilon

    sixth = hmax / 6
    h1 = sixth * (g - r) / max_min + sixth          # when b is min
    h2 = sixth * (b - g) / max_min + 3 * sixth      # when r is min
    h3 = sixth * (r - b) / max_min + 5 * sixth      # when g is min
    h = torch.where(argmin == 2, h1,
                    torch.where(argmin == 0, h2,
                                torch.where(argmin == 1, h3,
                                            torch.zeros_like(h1))))
    s = max_min / (max_rgb + epsilon)
    return torch.stack([h, s, max_rgb], dim=-3)
