"""Diffusion noise schedules (host-side numpy; produce the gamma lookup table).

Copy of ``bio_diffusion_tpu/ops/schedules.py`` (which imports jax through its
package).  All functions return float64 numpy; the EVD installs the gamma
table as a float32 tensor.
"""

from __future__ import annotations

import numpy as np


def cosine_beta_schedule(num_timesteps: int, s: float = 0.008, raise_to_power: float = 1.0) -> np.ndarray:
    """Cosine alpha^2 cumulative schedule with beta clipping; length T+1."""
    steps = num_timesteps + 2
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    betas = np.clip(betas, a_min=0.0, a_max=0.999)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    if raise_to_power != 1.0:
        alphas_cumprod = np.power(alphas_cumprod, raise_to_power)
    return alphas_cumprod


def clip_noise_schedule(alphas2: np.ndarray, clip_value: float = 0.001) -> np.ndarray:
    """Clip per-step alpha ratios for sampling stability."""
    alphas2 = np.concatenate([np.ones(1), alphas2], axis=0)
    alphas_step = alphas2[1:] / alphas2[:-1]
    alphas_step = np.clip(alphas_step, a_min=clip_value, a_max=1.0)
    return np.cumprod(alphas_step, axis=0)


def polynomial_schedule(num_timesteps: int, s: float = 1e-4, power: float = 3.0) -> np.ndarray:
    """``(1 - (t/T)^power)^2`` alpha^2 schedule, clipped and precision-scaled; length T+1."""
    steps = num_timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1.0 - np.power(x / steps, power)) ** 2
    alphas2 = clip_noise_schedule(alphas2, clip_value=0.001)
    precision = 1.0 - 2.0 * s
    return precision * alphas2 + s


def predefined_gamma_table(
    noise_schedule: str,
    num_timesteps: int,
    noise_precision: float = 1e-5,
) -> np.ndarray:
    """gamma(t) lookup table of length T+1, indexed by round(t * T).

    gamma = -log(alpha^2 / sigma^2); sigma^2 = 1 - alpha^2.
    ``noise_schedule`` is "cosine" or "polynomial_<power>".
    """
    if noise_schedule == "cosine":
        alphas2 = cosine_beta_schedule(num_timesteps)
    elif "polynomial" in noise_schedule:
        splits = noise_schedule.split("_")
        if len(splits) != 2:
            raise ValueError(f"Bad polynomial schedule spec: {noise_schedule}")
        power = float(splits[1])
        alphas2 = polynomial_schedule(num_timesteps, s=noise_precision, power=power)
    else:
        raise ValueError(f"Unknown noise schedule: {noise_schedule}")

    sigmas2 = 1.0 - alphas2
    log_alphas2 = np.log(alphas2)
    log_sigmas2 = np.log(sigmas2)
    return -(log_alphas2 - log_sigmas2)
