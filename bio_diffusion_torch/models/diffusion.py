"""Equivariant variational diffusion (EVD): the sampling half.

Port of ``bio_diffusion_tpu/models/diffusion.py``: the predefined gamma
table, the sigma/alpha algebra, CoM-free noise, one ancestral reverse step,
the final decode and the reverse loop.  Every function that draws noise takes
an explicit ``torch.Generator`` and also accepts the raw standard-normal
draws as a tensor (``noise``), so tests can pass in another framework's
draws; raw draws are masked and CoM-projected exactly like fresh ones.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bio_diffusion_tpu.config.schema import DataloaderConfig, DiffusionConfig, compute_num_atom_types
from bio_diffusion_torch.ops.geometry import centralize
from bio_diffusion_torch.ops.schedules import predefined_gamma_table

Tensor = torch.Tensor


class EquivariantVariationalDiffusion(nn.Module):
    """eps-parametrized E(3) diffusion over (x, h), holding ``dynamics_network``."""

    def __init__(self, dynamics_network: nn.Module, diffusion_cfg: DiffusionConfig,
                 dataloader_cfg: DataloaderConfig):
        super().__init__()
        dc = diffusion_cfg
        if dc.parametrization != "eps":
            raise ValueError("eps is the only supported parametrization")
        if dc.noise_schedule == "learned":
            raise NotImplementedError("the learned noise schedule is not ported yet")
        self.dynamics_network = dynamics_network
        self.diffusion_cfg = dc
        self.dataloader_cfg = dataloader_cfg
        table = predefined_gamma_table(dc.noise_schedule, dc.num_timesteps, dc.noise_precision)
        self.register_buffer("gamma_table", torch.tensor(table, dtype=torch.float32),
                             persistent=False)

    # -- basic quantities ------------------------------------------------------

    @property
    def T(self) -> int:
        return self.diffusion_cfg.num_timesteps

    @property
    def num_x_dims(self) -> int:
        return self.dataloader_cfg.num_x_dims

    @property
    def num_atom_types(self) -> int:
        return compute_num_atom_types(self.dataloader_cfg)

    @property
    def include_charges(self) -> bool:
        return bool(self.dataloader_cfg.include_charges)

    @property
    def num_node_scalar_features(self) -> int:
        return self.num_atom_types + int(self.include_charges)

    def gamma(self, t: Tensor) -> Tensor:
        """gamma(t) for normalized t in [0, 1]; ``round`` is half-to-even, as in JAX."""
        t_int = torch.clamp(torch.round(t * self.T).long(), 0, self.T)
        return self.gamma_table[t_int]

    @staticmethod
    def sigma(gamma: Tensor) -> Tensor:
        return torch.sqrt(torch.sigmoid(gamma))

    @staticmethod
    def alpha(gamma: Tensor) -> Tensor:
        return torch.sqrt(torch.sigmoid(-gamma))

    @staticmethod
    def snr(gamma: Tensor) -> Tensor:
        return torch.exp(-gamma)

    @staticmethod
    def sigma_and_alpha_t_given_s(gamma_t: Tensor, gamma_s: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        sigma2_t_given_s = -torch.expm1(F.softplus(gamma_s) - F.softplus(gamma_t))
        log_alpha2_t = F.logsigmoid(-gamma_t)
        log_alpha2_s = F.logsigmoid(-gamma_s)
        alpha_t_given_s = torch.exp(0.5 * (log_alpha2_t - log_alpha2_s))
        return sigma2_t_given_s, torch.sqrt(sigma2_t_given_s), alpha_t_given_s

    def unnormalize(self, x: Tensor, node_mask: Tensor, h_cat: Tensor, h_int: Tensor):
        nv = self.diffusion_cfg.norm_values
        nb = self.diffusion_cfg.norm_biases
        m = node_mask.to(x.dtype)[..., None]
        x = x * nv[0]
        h_cat = (h_cat * nv[1] + nb[1]) * m
        h_int = h_int * nv[2] + nb[2]
        if self.include_charges:
            h_int = h_int * m
        return x, h_cat, h_int

    # -- noise -------------------------------------------------------------------

    def sample_noise(self, node_mask: Tensor, generator: Optional[torch.Generator] = None,
                     fix_noise: bool = False, noise: Optional[Tensor] = None) -> Tensor:
        """CoM-free x-noise and iid h-noise, masked, ``[B, N, 3+F]``.

        ``noise``: the raw standard-normal draws (``[B or 1, N, 3+F]``) to use
        instead of drawing from ``generator``; ``fix_noise`` broadcasts one
        row to every molecule."""
        b, n = node_mask.shape
        nx, nf = self.num_x_dims, self.num_node_scalar_features
        if noise is None:
            noise = torch.randn((1 if fix_noise else b, n, nx + nf), generator=generator,
                                device=node_mask.device, dtype=torch.float32)
        noise = noise.expand(b, n, nx + nf)
        m = node_mask.to(noise.dtype)[..., None]
        _, zx = centralize(noise[..., :nx] * m, node_mask)
        return torch.cat([zx, noise[..., nx:] * m], dim=-1)

    # -- reverse process -----------------------------------------------------------

    def sample_p_zs_given_zt(self, s: Tensor, t: Tensor, z: Tensor, node_mask: Tensor,
                             generator: Optional[torch.Generator] = None, fix_noise: bool = False,
                             noise: Optional[Tensor] = None) -> Tensor:
        """One ancestral reverse step z_t -> z_s."""
        gamma_s = self.gamma(s)
        gamma_t = self.gamma(t)
        sigma2_tgs, sigma_tgs, alpha_tgs = self.sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        sigma_s = self.sigma(gamma_s)
        sigma_t = self.sigma(gamma_t)

        eps_t = self.dynamics_network(z, t, node_mask)

        mu = z / alpha_tgs[..., None] - (sigma2_tgs / alpha_tgs / sigma_t)[..., None] * eps_t
        sigma = sigma_tgs * sigma_s / sigma_t  # [B, 1]
        eps = self.sample_noise(node_mask, generator, fix_noise, noise)
        zs = mu + sigma[..., None] * eps
        nx = self.num_x_dims
        _, zs_x = centralize(zs[..., :nx], node_mask)
        return torch.cat([zs_x, zs[..., nx:]], dim=-1)

    def sample_p_xh_given_z0(self, z_0: Tensor, node_mask: Tensor,
                             generator: Optional[torch.Generator] = None, fix_noise: bool = False,
                             noise: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
        """Final decode x, h ~ p(x, h | z_0) -> (x, one_hot, charges) on the data scale."""
        b = z_0.shape[0]
        t_zeros = torch.zeros((b, 1), dtype=z_0.dtype, device=z_0.device)
        gamma_0 = self.gamma(t_zeros)
        sigma_x = self.snr(-0.5 * gamma_0)

        net_out = self.dynamics_network(z_0, t_zeros, node_mask)

        sigma_0 = self.sigma(gamma_0)[..., None]
        alpha_0 = self.alpha(gamma_0)[..., None]
        mu_x = (z_0 - sigma_0 * net_out) / alpha_0
        xh = mu_x + sigma_x[..., None] * self.sample_noise(node_mask, generator, fix_noise, noise)

        nx, na = self.num_x_dims, self.num_atom_types
        x = xh[..., :nx]
        if self.include_charges:
            h_cat, h_int = xh[..., nx:-1], xh[..., -1:]
        else:
            h_cat, h_int = xh[..., nx:], torch.zeros_like(xh[..., :1])
        x, h_cat, h_int = self.unnormalize(x, node_mask, h_cat, h_int)

        m = node_mask.to(x.dtype)[..., None]
        one_hot = F.one_hot(torch.argmax(h_cat, dim=-1), na).to(x.dtype) * m
        charges = torch.round(h_int) * m if self.include_charges else torch.zeros_like(h_int)
        return x, one_hot, charges

    def init_sample_noise(self, node_mask: Tensor, generator: Optional[torch.Generator] = None,
                          fix_noise: bool = False, noise: Optional[Tensor] = None) -> Tensor:
        """z_T ~ p(z_T): the sampling prior (CoM-free x, iid h)."""
        return self.sample_noise(node_mask, generator, fix_noise, noise)

    def reverse_segment(self, z: Tensor, s_values: Sequence[float], t_values: Sequence[float],
                        node_mask: Tensor, generator: Optional[torch.Generator] = None,
                        fix_noise: bool = False, noises: Optional[Sequence[Tensor]] = None) -> Tensor:
        """Run reverse steps at the given normalized (s, t) pairs.  ``noises``:
        one raw draw per step instead of drawing from ``generator``."""
        b = node_mask.shape[0]
        for k, (s_val, t_val) in enumerate(zip(s_values, t_values)):
            s_arr = torch.full((b, 1), float(s_val), dtype=z.dtype, device=z.device)
            t_arr = torch.full((b, 1), float(t_val), dtype=z.dtype, device=z.device)
            z = self.sample_p_zs_given_zt(
                s_arr, t_arr, z, node_mask, generator, fix_noise,
                None if noises is None else noises[k],
            )
        return z

    def decode_sample(self, z: Tensor, node_mask: Tensor,
                      generator: Optional[torch.Generator] = None, fix_noise: bool = False,
                      noise: Optional[Tensor] = None) -> Tensor:
        """Final p(x, h | z_0) decode and CoM projection -> data-scale xh."""
        x, one_hot, charges = self.sample_p_xh_given_z0(z, node_mask, generator, fix_noise, noise)
        _, x = centralize(x, node_mask)
        if self.include_charges:
            return torch.cat([x, one_hot, charges], dim=-1)
        return torch.cat([x, one_hot], dim=-1)
