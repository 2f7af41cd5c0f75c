"""Equivariant variational diffusion (EVD): the training loss and the sampler.

Port of ``bio_diffusion_tpu/models/diffusion.py``: the noise schedule
(the predefined gamma table, or the learned ``GammaNetwork``), the
sigma/alpha algebra, CoM-free noise, the loss terms (L2 and VLB, KL prior,
the L0 likelihoods, the two-pass L0 estimate for evaluation, the
self-conditioning pass) and ``assemble_nll``, one ancestral reverse step,
the final decode, the reverse loop, the guided round trip of existing
molecules (``mol_gen_optimize``) and RePaint inpainting (``inpaint``, its
jump back ``sample_p_zt_given_zs`` and its schedule).  Every function that
runs the denoiser takes the property context of a conditioned model
(``context [B, N, C]``, else None) and hands it to each denoiser call.
Every function that draws takes an explicit ``torch.Generator`` and also
accepts the draws as tensors (``noise``, ``noises``, ``t_int``, ``eps_t``,
``eps_0``, ``sc_take``, ``eps_sc``, ``eps_sc_step``), so tests can pass in
another framework's draws; raw normal draws are masked and CoM-projected
exactly like fresh ones.

Self-conditioning (``diffusion_cfg.self_condition``): the denoiser also
takes an estimate of the clean state (``xh_self_cond``).  Every reverse
step then makes a second, no-grad denoiser call that estimates z_0 from
the new state (one more draw a step), carried to the next step and to the
decode; in training, with probability 0.5 a batch first takes that
estimate from the state one step noisier.

The learned schedule (``noise_schedule=learned``, VLB only) is the
reference's ``GammaNetwork``, registered as ``gamma`` (its parameters at
the reference's names ``gamma.l1.weight`` ... ``gamma.gamma_1``); the
predefined schedule's lookup is a module of that name too, so ``gamma(t)``
is one call either way.  The sampling loops (``reverse_segment``,
``decode_sample``, ``mol_gen_optimize``, ``inpaint``) read a learned
schedule from a table of its T+1 values on the grid k/T, linear in
between, as the JAX package's samplers read the table ``build_fast_evd``
freezes; the table is rebuilt whenever a parameter changed.  The loss
terms (the self-conditioning pass included) and a lone reverse step run
the network, as JAX's ``loss_terms`` does.

Two bugs of the reference stay fixed, as in the JAX package: ``inpaint``
reads ``num_denoise_steps`` before assigning it (its self-conditioning
s-array is zeros; built directly here), and ``sample_p_zt_given_zs``
indexes a ``[B, 1]`` tensor with a node-length mask (the intent, a per-graph
broadcast, is what the dense layout gives).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bio_diffusion_torch.config.schema import DataloaderConfig, DiffusionConfig, compute_num_atom_types
from bio_diffusion_torch.models.nn import DropoutDraws
from bio_diffusion_torch.ops.geometry import centralize
from bio_diffusion_torch.ops.schedules import predefined_gamma_table
from bio_diffusion_torch.utils.debug import check_correctly_masked, check_finite, check_mean_zero_with_mask

Tensor = torch.Tensor


def cdf_standard_gaussian(x: Tensor) -> Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gaussian_kl(q_mu_minus_p_mu_squared: Tensor, q_sigma: Tensor, p_sigma: Tensor, d) -> Tensor:
    """KL(N(q) || N(p)) integrated over ``d`` dimensions."""
    return (d * torch.log(p_sigma / q_sigma)
            + 0.5 * (d * q_sigma ** 2 + q_mu_minus_p_mu_squared) / (p_sigma ** 2)
            - 0.5 * d)


def sum_except_batch(values: Tensor) -> Tensor:
    """Sum a ``[B, N, F]`` tensor over nodes and features -> ``[B]``."""
    return values.sum(dim=(-1, -2))


# -- noise schedules -----------------------------------------------------------


class PredefinedGamma(nn.Module):
    """gamma(t) of a predefined schedule: its table of T+1 values, looked up
    at ``round(t * T)`` (half to even, as in JAX)."""

    def __init__(self, table: np.ndarray):
        super().__init__()
        self.T = len(table) - 1
        self.register_buffer("table", torch.tensor(table, dtype=torch.float32), persistent=False)

    def forward(self, t: Tensor) -> Tensor:
        return self.table[torch.clamp(torch.round(t * self.T).long(), 0, self.T)]


class PositiveLinear(nn.Module):
    """Linear layer with softplus-positive weights (``weight [out, in]``, the
    reference's layout; the JAX package keeps ``[in, out]``), weights
    initialized uniform in +-1/sqrt(in) and offset by ``weight_init_offset``."""

    def __init__(self, in_features: int, out_features: int, weight_init_offset: float = -2.0):
        super().__init__()
        self.in_features, self.weight_init_offset = in_features, weight_init_offset
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the weights on the host (``generator``: a CPU generator)."""
        bound = 1.0 / math.sqrt(self.in_features)
        self.weight.copy_(torch.empty(self.weight.shape).uniform_(-bound, bound, generator=generator)
                          + self.weight_init_offset)
        self.bias.copy_(torch.empty(self.bias.shape).uniform_(-bound, bound, generator=generator))

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x, F.softplus(self.weight), self.bias)


class GammaNetwork(nn.Module):
    """The learned, monotone gamma(t) (JAX ``GammaNetwork``): ``l1`` 1->1,
    ``l2`` 1->1024, ``l3`` 1024->1 of positive weights, its output rescaled
    between its values at 0 and 1 onto the learnable endpoints ``gamma_0``
    (-5 at first) and ``gamma_1`` (10), float32.

    While ``frozen`` (``EquivariantVariationalDiffusion.frozen_schedule``)
    ``forward`` reads :meth:`table` (its values at k/T, k = 0..T, linear in
    between), built once and rebuilt whenever a parameter changed (keyed on
    the parameters and their version counters, which every in-place update
    bumps); otherwise the network runs."""

    def __init__(self, num_timesteps: int):
        super().__init__()
        self.T = int(num_timesteps)
        self.l1 = PositiveLinear(1, 1)
        self.l2 = PositiveLinear(1, 1024)
        self.l3 = PositiveLinear(1024, 1)
        self.gamma_0 = nn.Parameter(torch.tensor([-5.0]))
        self.gamma_1 = nn.Parameter(torch.tensor([10.0]))
        self.frozen = False
        self._table: Optional[Tensor] = None
        self._table_key: Optional[tuple] = None

    def _apply(self, fn, *args, **kwargs):
        # moving or casting replaces the parameters' data without bumping
        # their version counters
        self.drop_weight_cache()
        return super()._apply(fn, *args, **kwargs)

    def drop_weight_cache(self) -> None:
        """Forget :meth:`table` (e.g. when the parameters' storage is released)."""
        self._table = None

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in (self.l1, self.l2, self.l3):
            layer.reset_parameters(generator)
        self.gamma_0.fill_(-5.0)
        self.gamma_1.fill_(10.0)

    def gamma_tilde(self, t: Tensor) -> Tensor:
        l1_t = self.l1(t)
        return l1_t + self.l3(torch.sigmoid(self.l2(l1_t)))

    def network(self, t: Tensor) -> Tensor:
        g0, g1 = self.gamma_tilde(torch.zeros_like(t)), self.gamma_tilde(torch.ones_like(t))
        normalized = (self.gamma_tilde(t) - g0) / (g1 - g0)
        return self.gamma_0 + (self.gamma_1 - self.gamma_0) * normalized

    def table(self) -> Tensor:
        """gamma(k/T) for k = 0..T, ``[T+1]``, detached (JAX
        ``build_fast_evd``'s ``gamma_table_override``)."""
        key = tuple((id(p), p._version) for p in self.parameters())
        if self._table is None or self._table_key != key:
            with torch.no_grad():
                grid = torch.arange(self.T + 1, dtype=torch.float32, device=self.gamma_0.device)[:, None] / self.T
                self._table = self.network(grid)[:, 0]
            self._table_key = key
        return self._table

    def forward(self, t: Tensor) -> Tensor:
        if not self.frozen:
            return self.network(t)
        table = self.table()
        tf = torch.clamp(t, 0.0, 1.0) * self.T
        lo = torch.clamp(torch.floor(tf).long(), 0, self.T - 1)
        frac = tf - lo.to(tf.dtype)
        return table[lo] * (1.0 - frac) + table[lo + 1] * frac


def sampling_loop(method):
    """Run an EVD method under ``frozen_schedule`` (the sampling loops)."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with self.frozen_schedule():
            return method(self, *args, **kwargs)
    return wrapped


class EquivariantVariationalDiffusion(nn.Module):
    """eps-parametrized E(3) diffusion over (x, h), holding ``dynamics_network``."""

    def __init__(self, dynamics_network: nn.Module, diffusion_cfg: DiffusionConfig,
                 dataloader_cfg: DataloaderConfig):
        super().__init__()
        dc = diffusion_cfg
        if dc.parametrization != "eps":
            raise ValueError("eps is the only supported parametrization")
        if dc.loss_type not in ("vlb", "l2"):
            raise ValueError(f"unknown loss_type {dc.loss_type!r}")
        self.dynamics_network = dynamics_network
        self.diffusion_cfg = dc
        self.dataloader_cfg = dataloader_cfg
        if dc.noise_schedule == "learned":
            if dc.loss_type != "vlb":
                raise ValueError("a learned schedule requires the VLB objective (loss_type=vlb)")
            self.gamma = GammaNetwork(dc.num_timesteps)
        else:
            self.gamma = PredefinedGamma(
                predefined_gamma_table(dc.noise_schedule, dc.num_timesteps, dc.noise_precision))

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

    @contextlib.contextmanager
    def frozen_schedule(self):
        """Within the block a learned schedule reads its frozen table (a
        predefined one is a table already)."""
        gamma = self.gamma
        if not isinstance(gamma, GammaNetwork) or gamma.frozen:
            yield
            return
        gamma.frozen = True
        try:
            yield
        finally:
            gamma.frozen = False

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

    def subspace_dimensionality(self, num_nodes: Tensor) -> Tensor:
        return (num_nodes - 1) * self.num_x_dims

    def normalize(self, x: Tensor, h_cat: Tensor, h_int: Tensor, node_mask: Tensor):
        nv = self.diffusion_cfg.norm_values
        nb = self.diffusion_cfg.norm_biases
        m = node_mask.to(x.dtype)[..., None]
        x = x / nv[0]
        h_cat = (h_cat - nb[1]) / nv[1] * m
        h_int = (h_int - nb[2]) / nv[2]
        if self.include_charges:
            h_int = h_int * m
        return x, h_cat, h_int

    def pack_xh(self, x: Tensor, h_cat: Tensor, h_int: Tensor) -> Tensor:
        if self.include_charges:
            return torch.cat([x, h_cat, h_int], dim=-1)
        return torch.cat([x, h_cat], dim=-1)

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

    def unnormalize_z(self, z: Tensor, node_mask: Tensor) -> Tensor:
        """A packed state ``[x | h_cat | h_int]`` on the data scale."""
        nx, na = self.num_x_dims, self.num_atom_types
        x, h_cat, h_int = self.unnormalize(z[..., :nx], node_mask, z[..., nx: nx + na], z[..., nx + na:])
        return torch.cat([x, h_cat, h_int], dim=-1)

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

    # -- training loss -----------------------------------------------------------

    def compute_noised_representation(self, xh: Tensor, node_mask: Tensor, gamma_t: Tensor,
                                      generator: Optional[torch.Generator] = None,
                                      noise: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        alpha_t = self.alpha(gamma_t)[..., None]
        sigma_t = self.sigma(gamma_t)[..., None]
        eps = self.sample_noise(node_mask, generator, noise=noise)
        return alpha_t * xh + sigma_t * eps, eps

    def compute_kl_prior(self, xh: Tensor, node_mask: Tensor, num_nodes: Tensor) -> Tensor:
        """KL(q(z_T | x) || N(0, 1))."""
        b = xh.shape[0]
        gamma_T = self.gamma(torch.ones((b, 1), dtype=xh.dtype, device=xh.device))
        alpha_T = self.alpha(gamma_T)[..., None]
        mu_T = alpha_T * xh
        nx = self.num_x_dims
        mu_T_x, mu_T_h = mu_T[..., :nx], mu_T[..., nx:]
        sigma_T = self.sigma(gamma_T)[..., 0]
        kl_x = gaussian_kl(sum_except_batch(mu_T_x ** 2), sigma_T, torch.ones_like(sigma_T),
                           self.subspace_dimensionality(num_nodes))
        m = node_mask.to(xh.dtype)[..., None]
        # the reference integrates the h-KL with d=1; kept
        kl_h = gaussian_kl(sum_except_batch((mu_T_h ** 2) * m), sigma_T, torch.ones_like(sigma_T), 1.0)
        return kl_x + kl_h

    def log_constants_p_x_given_z0(self, num_nodes: Tensor, gamma_0: Tensor) -> Tensor:
        d = self.subspace_dimensionality(num_nodes)
        log_sigma_x = 0.5 * gamma_0[..., 0]
        return d * (-log_sigma_x - 0.5 * math.log(2 * math.pi))

    def log_pxh_given_z0_without_constants(self, h_cat_norm: Tensor, h_int_norm: Tensor, z_0: Tensor,
                                           eps: Tensor, net_out: Tensor, gamma_0: Tensor,
                                           node_mask: Tensor, epsilon: float = 1e-10
                                           ) -> Tuple[Tensor, Tensor]:
        """L0 decoder likelihoods: Gaussian L2 for x, CDF-integral
        likelihoods for the one-hot types and the integer charges."""
        nv = self.diffusion_cfg.norm_values
        nb = self.diffusion_cfg.norm_biases
        nx = self.num_x_dims
        m = node_mask.to(z_0.dtype)[..., None]
        log_p_x_given_z0 = -0.5 * sum_except_batch((eps[..., :nx] - net_out[..., :nx]) ** 2)
        if self.include_charges:
            z_h_cat, z_h_int = z_0[..., nx:-1], z_0[..., -1:]
        else:
            z_h_cat = z_0[..., nx:]
        sigma_0 = self.sigma(gamma_0)[..., None]
        sigma_0_cat = sigma_0 * nv[1]
        sigma_0_int = sigma_0 * nv[2]
        onehot = h_cat_norm * nv[1] + nb[1]
        estimated_h_cat = z_h_cat * nv[1] + nb[1]
        if self.include_charges:
            h_integer = torch.round(h_int_norm * nv[2] + nb[2])
            centered = h_integer - (z_h_int * nv[2] + nb[2])
            log_ph_integer = torch.log(
                cdf_standard_gaussian((centered + 0.5) / sigma_0_int)
                - cdf_standard_gaussian((centered - 0.5) / sigma_0_int)
                + epsilon)
            log_ph_integer = sum_except_batch(log_ph_integer * m)
        else:
            log_ph_integer = torch.zeros(z_0.shape[0], dtype=z_0.dtype, device=z_0.device)
        centered_h_cat = estimated_h_cat - 1.0
        log_ph_cat_proportional = torch.log(
            cdf_standard_gaussian((centered_h_cat + 0.5) / sigma_0_cat)
            - cdf_standard_gaussian((centered_h_cat - 0.5) / sigma_0_cat)
            + epsilon)
        log_z = torch.logsumexp(log_ph_cat_proportional, dim=-1, keepdim=True)
        log_ph_cat = sum_except_batch((log_ph_cat_proportional - log_z) * onehot * m)
        return log_p_x_given_z0, log_ph_integer + log_ph_cat

    def loss_draws(self, node_mask: Tensor, generator: Optional[torch.Generator] = None, training: bool = True,
                   **given: Optional[Tensor]) -> Dict[str, Tensor]:
        """The draws :meth:`loss_terms` takes, in its order and shapes, each
        from ``given`` where it is there and not None, else from
        ``generator``: ``t_int [B, 1]`` (integers), ``eps_t [B, N, 3+F]``
        (raw normal draws); with self-conditioning in training ``sc_take``
        (a 0-dim bool, the Bernoulli(0.5) of the whole batch), ``eps_sc`` and
        ``eps_sc_step``; in evaluation ``eps_0``."""
        b, n = node_mask.shape
        dev = node_mask.device
        nf = self.num_x_dims + self.num_node_scalar_features

        def normal():
            return torch.randn((b, n, nf), generator=generator, device=dev, dtype=torch.float32)

        makers = [("t_int", lambda: torch.randint(0 if training else 1, self.T + 1, (b, 1), generator=generator,
                                                  device=dev)),
                  ("eps_t", normal)]
        if training and self.diffusion_cfg.self_condition:
            makers += [("sc_take", lambda: torch.rand((), generator=generator, device=dev) < 0.5),
                       ("eps_sc", normal), ("eps_sc_step", normal)]
        if not training:
            makers.append(("eps_0", normal))
        return {k: given[k] if given.get(k) is not None else make() for k, make in makers}

    def loss_terms(self, x: Tensor, h_cat: Tensor, h_int: Tensor, node_mask: Tensor, training: bool,
                   generator: Optional[torch.Generator] = None, t_int: Optional[Tensor] = None,
                   eps_t: Optional[Tensor] = None, eps_0: Optional[Tensor] = None,
                   context: Optional[Tensor] = None, sc_take=None, eps_sc: Optional[Tensor] = None,
                   eps_sc_step: Optional[Tensor] = None,
                   dropout_rows: Optional[Tuple[int, slice]] = None) -> Dict[str, Tensor]:
        """All per-graph loss/NLL terms; ``x`` must already be CoM-free.

        Draws come from ``generator`` unless given (:meth:`loss_draws`):
        ``t_int [B, 1]`` (integer timesteps, as floats), ``eps_t`` and
        (evaluation) ``eps_0``, raw normal draws ``[B, N, 3+F]``; with
        self-conditioning in training ``sc_take`` (a bool or 0-dim tensor)
        and the pass's ``eps_sc`` and ``eps_sc_step``.  As in the reference,
        the L2 error sums the h residual over all node rows, padded ones
        included (eps is 0 there, so they contribute ||net_h||^2).  With
        ``debug_invariants`` the inputs, z_t and the denoiser's output are
        checked at the JAX package's sites (``utils/debug.py``).

        Self-conditioning in training: when ``sc_take`` holds and no row's
        t_int is T, a no-grad pass noises the batch at t+1 (``eps_sc``) and
        takes one reverse step to s=0 from there (``eps_sc_step``); its
        result is the main denoiser call's ``xh_self_cond``, else zeros
        (also in evaluation).  Deciding reads one value back to the host.

        In training the main denoiser call draws its dropout masks (a model
        with GCP dropout) from ``generator``, after the draws above; a
        data-parallel rank passes ``dropout_rows`` (the global batch's size,
        its rows) to draw them at the global batch's shape and keep its
        rows.  Every other denoiser call is deterministic (JAX
        ``deterministic=not training``)."""
        dc = self.diffusion_cfg
        b = node_mask.shape[0]
        num_nodes = node_mask.to(x.dtype).sum(dim=-1)
        dbg = dc.debug_invariants
        check_mean_zero_with_mask(dbg, x, node_mask, "input x")
        check_correctly_masked(dbg, x, node_mask, "input x")
        check_correctly_masked(dbg, h_cat, node_mask, "input h_cat")
        check_correctly_masked(dbg, h_int, node_mask, "input h_int")
        x, h_cat, h_int = self.normalize(x, h_cat, h_int, node_mask)
        xh = self.pack_xh(x, h_cat, h_int)
        l2_train = training and dc.loss_type == "l2"
        draws = self.loss_draws(node_mask, generator, training, t_int=t_int, eps_t=eps_t, eps_0=eps_0,
                                sc_take=sc_take, eps_sc=eps_sc, eps_sc_step=eps_sc_step)

        delta_log_px = -self.subspace_dimensionality(num_nodes) * math.log(dc.norm_values[0])
        if l2_train:
            delta_log_px = torch.zeros_like(delta_log_px)
        t_int = draws["t_int"].to(x.dtype)
        t_is_zero = (t_int == 0).to(x.dtype)
        s = (t_int - 1.0) / self.T
        t = t_int / self.T
        gamma_s, gamma_t = self.gamma(s), self.gamma(t)

        z_t, eps_t = self.compute_noised_representation(xh, node_mask, gamma_t, noise=draws["eps_t"])
        check_mean_zero_with_mask(dbg, z_t[..., :self.num_x_dims], node_mask, "z_t positions")
        self_cond = None
        if dc.self_condition:
            self_cond = torch.zeros_like(xh)
            if training and bool(torch.logical_and(torch.as_tensor(draws["sc_take"], device=x.device),
                                                   ~(t_int == self.T).any())):
                with torch.no_grad():
                    t_sc = (t_int + 1.0) / self.T
                    z_t_sc, _ = self.compute_noised_representation(xh, node_mask, self.gamma(t_sc),
                                                                   noise=draws["eps_sc"])
                self_cond = self.self_condition_step(t_sc, z_t_sc, node_mask, noise=draws["eps_sc_step"],
                                                     context=context)
        dropout = DropoutDraws(generator, *(dropout_rows or ())) if training else None
        net_out = self.dynamics_network(z_t, t, node_mask, context, self_cond, dropout=dropout)
        check_correctly_masked(dbg, net_out[..., :self.num_x_dims], node_mask, "net_out vel")
        check_finite(dbg, net_out, "net_out")
        error_t = sum_except_batch((eps_t - net_out) ** 2)
        snr_weight = (torch.ones_like(error_t) if l2_train
                      else (self.snr(gamma_s - gamma_t) - 1.0)[..., 0])
        gamma_0 = self.gamma(torch.zeros((b, 1), dtype=x.dtype, device=x.device))
        neg_log_constants = -self.log_constants_p_x_given_z0(num_nodes, gamma_0)
        if l2_train:
            neg_log_constants = torch.zeros_like(neg_log_constants)
        kl_prior = self.compute_kl_prior(xh, node_mask, num_nodes)

        if training:
            log_p_x, log_p_h = self.log_pxh_given_z0_without_constants(
                h_cat, h_int, z_t, eps_t, net_out, gamma_t, node_mask)
            loss_0_x = -log_p_x * t_is_zero[..., 0]
            loss_0_h = -log_p_h * t_is_zero[..., 0]
            error_t = error_t * (1.0 - t_is_zero[..., 0])
        else:
            # a separate z_0 pass: a lower-variance L0 estimate
            t_zeros = torch.zeros_like(s)
            z_0, eps_0 = self.compute_noised_representation(xh, node_mask, gamma_0, noise=draws["eps_0"])
            net_out_0 = self.dynamics_network(z_0, t_zeros, node_mask, context)
            log_p_x, log_p_h = self.log_pxh_given_z0_without_constants(
                h_cat, h_int, z_0, eps_0, net_out_0, gamma_0, node_mask)
            loss_0_x, loss_0_h = -log_p_x, -log_p_h

        nx = self.num_x_dims
        m = node_mask.to(x.dtype)
        count = torch.clamp(m.sum(dim=-1), min=1.0)
        eps_hat_x = ((net_out[..., :nx].abs().mean(dim=-1) * m).sum(dim=-1) / count).mean()
        eps_hat_h = ((net_out[..., nx:].abs().mean(dim=-1) * m).sum(dim=-1) / count).mean()
        return {
            "delta_log_px": delta_log_px, "error_t": error_t, "SNR_weight": snr_weight,
            "loss_0_x": loss_0_x, "loss_0_h": loss_0_h, "neg_log_constants": neg_log_constants,
            "kl_prior": kl_prior, "t_int": t_int[..., 0], "num_nodes": num_nodes,
            "eps_hat_x": eps_hat_x, "eps_hat_h": eps_hat_h,
        }

    # -- reverse process -----------------------------------------------------------

    def sample_p_zs_given_zt(self, s: Tensor, t: Tensor, z: Tensor, node_mask: Tensor,
                             generator: Optional[torch.Generator] = None, fix_noise: bool = False,
                             noise: Optional[Tensor] = None, context: Optional[Tensor] = None,
                             xh_self_cond: Optional[Tensor] = None) -> Tensor:
        """One ancestral reverse step z_t -> z_s."""
        gamma_s = self.gamma(s)
        gamma_t = self.gamma(t)
        sigma2_tgs, sigma_tgs, alpha_tgs = self.sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        sigma_s = self.sigma(gamma_s)
        sigma_t = self.sigma(gamma_t)

        eps_t = self.dynamics_network(z, t, node_mask, context, xh_self_cond)

        mu = z / alpha_tgs[..., None] - (sigma2_tgs / alpha_tgs / sigma_t)[..., None] * eps_t
        sigma = sigma_tgs * sigma_s / sigma_t  # [B, 1]
        eps = self.sample_noise(node_mask, generator, fix_noise, noise)
        zs = mu + sigma[..., None] * eps
        nx = self.num_x_dims
        _, zs_x = centralize(zs[..., :nx], node_mask)
        return torch.cat([zs_x, zs[..., nx:]], dim=-1)

    def self_condition_step(self, s: Tensor, z: Tensor, node_mask: Tensor,
                            generator: Optional[torch.Generator] = None, fix_noise: bool = False,
                            noise: Optional[Tensor] = None, context: Optional[Tensor] = None) -> Tensor:
        """The next step's self-conditioning input: one reverse step from the
        new state ``z`` at ``s`` to 0, without gradients and without a
        self-conditioning input of its own."""
        with torch.no_grad():
            return self.sample_p_zs_given_zt(torch.zeros_like(s), s, z, node_mask, generator, fix_noise, noise,
                                             context)

    def sample_p_zt_given_zs(self, zs: Tensor, node_mask: Tensor, gamma_t: Tensor, gamma_s: Tensor,
                             generator: Optional[torch.Generator] = None, noise: Optional[Tensor] = None) -> Tensor:
        """Jump back: renoise z_s -> z_t (RePaint); the step's sigma and alpha
        broadcast per graph."""
        _, sigma_tgs, alpha_tgs = self.sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        zt = alpha_tgs[..., None] * zs + sigma_tgs[..., None] * self.sample_noise(node_mask, generator, noise=noise)
        nx = self.num_x_dims
        _, zt_x = centralize(zt[..., :nx], node_mask)
        return torch.cat([zt_x, zt[..., nx:]], dim=-1)

    def sample_p_xh_given_z0(self, z_0: Tensor, node_mask: Tensor,
                             generator: Optional[torch.Generator] = None, fix_noise: bool = False,
                             noise: Optional[Tensor] = None, context: Optional[Tensor] = None,
                             xh_self_cond: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
        """Final decode x, h ~ p(x, h | z_0) -> (x, one_hot, charges) on the data scale."""
        b = z_0.shape[0]
        t_zeros = torch.zeros((b, 1), dtype=z_0.dtype, device=z_0.device)
        gamma_0 = self.gamma(t_zeros)
        sigma_x = self.snr(-0.5 * gamma_0)

        net_out = self.dynamics_network(z_0, t_zeros, node_mask, context, xh_self_cond)

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

    @property
    def draws_per_step(self) -> int:
        """Raw draws a reverse step takes: its own, and a self-conditioned
        model's second step."""
        return 2 if self.diffusion_cfg.self_condition else 1

    @sampling_loop
    def reverse_segment(self, z: Tensor, s_values: Sequence[float], t_values: Sequence[float],
                        node_mask: Tensor, generator: Optional[torch.Generator] = None,
                        fix_noise: bool = False, noises: Optional[Sequence[Tensor]] = None,
                        context: Optional[Tensor] = None, frames: Optional[Tensor] = None,
                        frame_steps: Optional[Sequence[int]] = None,
                        self_cond: Optional[Tensor] = None) -> Tuple[Tensor, Optional[Tensor]]:
        """Run reverse steps at the given normalized (s, t) pairs -> ``(z,
        self_cond)``.  A self-conditioned model carries ``self_cond``
        (zeros where None) into each step and replaces it after the step
        with :meth:`self_condition_step` of the new state (``fix_noise``
        too); otherwise it stays None.  ``noises``: the raw draws instead of
        drawing from ``generator``, ``draws_per_step`` a step (the step's,
        then the self-conditioning step's).  ``frames [len(frame_steps), B,
        N, 3+F]``: a preallocated tensor on the state's device that receives
        ``unnormalize_z`` of the state after each step listed in
        ``frame_steps`` (in order; nothing is read back to the host here)."""
        b = node_mask.shape[0]
        per = self.draws_per_step
        if self.diffusion_cfg.self_condition and self_cond is None:
            self_cond = torch.zeros_like(z)
        slot = {} if frames is None else {int(k): i for i, k in enumerate(frame_steps)}

        def draw(i):
            return None if noises is None else noises[i]

        for k, (s_val, t_val) in enumerate(zip(s_values, t_values)):
            s_arr = torch.full((b, 1), float(s_val), dtype=z.dtype, device=z.device)
            t_arr = torch.full((b, 1), float(t_val), dtype=z.dtype, device=z.device)
            z = self.sample_p_zs_given_zt(s_arr, t_arr, z, node_mask, generator, fix_noise, draw(per * k),
                                          context, self_cond)
            if self_cond is not None:
                self_cond = self.self_condition_step(s_arr, z, node_mask, generator, fix_noise, draw(per * k + 1),
                                                     context)
            if k in slot:
                frames[slot[k]].copy_(self.unnormalize_z(z, node_mask))
        return z, self_cond

    @sampling_loop
    def decode_sample(self, z: Tensor, node_mask: Tensor,
                      generator: Optional[torch.Generator] = None, fix_noise: bool = False,
                      noise: Optional[Tensor] = None, context: Optional[Tensor] = None,
                      self_cond: Optional[Tensor] = None) -> Tensor:
        """Final p(x, h | z_0) decode (with the last ``self_cond`` of a
        self-conditioned model) and CoM projection -> data-scale xh."""
        x, one_hot, charges = self.sample_p_xh_given_z0(z, node_mask, generator, fix_noise, noise, context,
                                                        self_cond)
        _, x = centralize(x, node_mask)
        if self.include_charges:
            return torch.cat([x, one_hot, charges], dim=-1)
        return torch.cat([x, one_hot], dim=-1)

    @sampling_loop
    def mol_gen_optimize(self, x: Tensor, h_cat: Tensor, node_mask: Tensor, num_timesteps: int,
                         context: Optional[Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         noises: Optional[Sequence[Tensor]] = None,
                         norm_with_original_timesteps: bool = False) -> Tensor:
        """Guided round trip of existing molecules: normalize ``(x, h_cat)``
        (CoM-free positions, one-hot types), run the last ``num_timesteps``
        reverse steps from there, decode and centralize -> ``[x | one_hot]``
        on the data scale.  Only for models without the charge channel (the
        conditional QM9 model).  ``noises``: ``draws_per_step`` raw draws a
        step and one for the decode instead of drawing from ``generator``.
        The steps run at s / ``num_timesteps``, or, with
        ``norm_with_original_timesteps``, at s / T (the model's last
        ``num_timesteps`` steps)."""
        if self.include_charges:
            raise ValueError(
                "mol_gen_optimize requires an include_charges=False model (the guided-optimization "
                "protocol runs the conditional QM9 model, which is trained without the charge channel)")
        count = self.draws_per_step * num_timesteps + 1
        if noises is not None and len(noises) != count:
            raise ValueError(f"noises: need {count} draws, got {len(noises)}")
        x_n, h_cat_n, _ = self.normalize(x, h_cat, torch.zeros_like(x[..., :1]), node_mask)
        z = torch.cat([x_n, h_cat_n], dim=-1)
        denom = np.float32(self.T if norm_with_original_timesteps else num_timesteps)
        s_values = np.arange(num_timesteps - 1, -1, -1, dtype=np.float32)
        z, self_cond = self.reverse_segment(z, s_values / denom, (s_values + 1) / denom, node_mask,
                                            generator, noises=None if noises is None else noises[:-1],
                                            context=context)
        return self.decode_sample(z, node_mask, generator, noise=None if noises is None else noises[-1],
                                  context=context, self_cond=self_cond)

    # -- RePaint inpainting -------------------------------------------------------

    @staticmethod
    def get_repaint_schedule(resamplings: int, jump_length: int, num_timesteps: int) -> List[int]:
        """RePaint's denoising segment lengths, last segment first."""
        curr_t = 0
        schedule: List[int] = []
        while curr_t < num_timesteps:
            if curr_t + jump_length < num_timesteps:
                if schedule:
                    schedule[-1] += jump_length
                    schedule.extend([jump_length] * (resamplings - 1))
                else:
                    schedule.extend([jump_length] * resamplings)
                curr_t += jump_length
            else:
                residual = num_timesteps - curr_t
                if schedule:
                    schedule[-1] += residual
                else:
                    schedule.append(residual)
                curr_t += residual
        return list(reversed(schedule))

    @staticmethod
    def repaint_step_arrays(schedule: List[int], jump_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """The schedule as one ``(s_value, jump_flag)`` pair a step: after the
        last step of every segment but the final one, jump ``jump_length``
        steps back."""
        s_vals, jump_flags = [], []
        s = sum(schedule) - (len(schedule) - 1) * jump_length - 1
        for i, num_denoise_steps in enumerate(schedule):
            for j in range(num_denoise_steps):
                s_vals.append(s)
                will_jump = (j == num_denoise_steps - 1) and (i < len(schedule) - 1)
                jump_flags.append(will_jump)
                if will_jump:
                    s = s + jump_length
                s -= 1
        return np.array(s_vals, dtype=np.float32), np.array(jump_flags, dtype=bool)

    @sampling_loop
    def inpaint(self, x0: Tensor, h0_cat: Tensor, h0_int: Tensor, node_mask: Tensor, node_mask_fixed: Tensor,
                num_resamplings: int = 1, jump_length: int = 1, num_timesteps: Optional[int] = None,
                generator: Optional[torch.Generator] = None, noises: Optional[Sequence[Tensor]] = None,
                context: Optional[Tensor] = None) -> Tensor:
        """RePaint inpainting: keep the nodes flagged in ``node_mask_fixed``
        (their data ``x0``, ``h0_cat``, ``h0_int``), generate the rest ->
        data-scale ``[x | one_hot (| charges)]``, CoM-free.

        The known part is centred on its CoM; at every step it is noised to
        the step's level and shifted so that its CoM is the denoised part's
        CoM over the same nodes, then the two are merged; after the last
        step of each segment but the final one the state jumps back
        ``jump_length`` steps.  A self-conditioned model carries its
        self-conditioning input from step to step, each step's taken from
        the generated part's new state, and decodes with the last.
        ``noises``: the raw draws instead of drawing from ``generator``, in
        the order of the JAX package's key splits: one for the prior, then
        per step one for the known part, one for the reverse step, one for
        the self-conditioning step (read only by a self-conditioned model)
        and one for the jump (read only where the step jumps), then one for
        the decode."""
        T_s = self.T if num_timesteps is None else int(num_timesteps)
        s_vals, jump_flags = self.repaint_step_arrays(
            self.get_repaint_schedule(num_resamplings, jump_length, T_s), jump_length)
        count = 4 * len(s_vals) + 2
        if noises is not None and len(noises) != count:
            raise ValueError(f"noises: need {count} draws, got {len(noises)}")

        def draw(k):
            return None if noises is None else noises[k]

        b, nx = node_mask.shape[0], self.num_x_dims
        mf = node_mask_fixed.to(x0.dtype)[..., None]
        m = node_mask.to(x0.dtype)[..., None]
        x0n, h0cn, h0in = self.normalize(x0, h0_cat, h0_int, node_mask)
        xh0 = self.pack_xh(x0n, h0cn, h0in)
        count_known = torch.clamp(mf.sum(dim=-2), min=1.0)  # [B, 1]
        mean_known = (x0n * mf).sum(dim=-2) / count_known
        xh0 = torch.cat([(xh0[..., :nx] - mean_known[:, None, :]) * m, xh0[..., nx:]], dim=-1)

        z = self.sample_noise(node_mask, generator, noise=draw(0))
        self_cond = torch.zeros_like(z) if self.diffusion_cfg.self_condition else None
        for k, (s_val, jump) in enumerate(zip(s_vals, jump_flags)):
            s_full = torch.full((b, 1), float(s_val), dtype=z.dtype, device=z.device)
            s_arr, t_arr = s_full / T_s, (s_full + 1.0) / T_s
            gamma_s = self.gamma(s_arr)
            z_known, _ = self.compute_noised_representation(xh0, node_mask, gamma_s, generator, draw(4 * k + 1))
            z_unknown = self.sample_p_zs_given_zt(s_arr, t_arr, z, node_mask, generator, noise=draw(4 * k + 2),
                                                  context=context, xh_self_cond=self_cond)
            if self_cond is not None:
                self_cond = self.self_condition_step(s_arr, z_unknown, node_mask, generator, noise=draw(4 * k + 3),
                                                     context=context)
            com_noised = (z_known[..., :nx] * mf).sum(dim=-2) / count_known
            com_denoised = (z_unknown[..., :nx] * mf).sum(dim=-2) / count_known
            z_known = torch.cat([z_known[..., :nx] + (com_denoised - com_noised)[:, None, :] * m,
                                 z_known[..., nx:]], dim=-1)
            z = (z_known * mf + z_unknown * (1.0 - mf)) * m
            if jump:
                gamma_t = self.gamma((s_full + jump_length) / T_s)
                z = self.sample_p_zt_given_zs(z, node_mask, gamma_t, gamma_s, generator, noise=draw(4 * k + 4))
        return self.decode_sample(z, node_mask, generator, noise=draw(4 * len(s_vals) + 1), context=context,
                                  self_cond=self_cond)


def assemble_nll(terms: Dict[str, Tensor], loss_type: str, training: bool, T: int, num_x_dims: int,
                 num_node_scalar_features: int, log_pN: Tensor,
                 norm_training_by_max_nodes: bool = False,
                 max_num_nodes: Optional[Tensor] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Combine the loss terms into the objective per graph -> ``(nll [B],
    info dict of batch-mean scalars)``.  ``max_num_nodes``: the largest
    molecule of the whole batch where ``terms`` hold one rank's rows of it
    (``norm_training_by_max_nodes``); else the largest in ``terms``."""
    error_t = terms["error_t"]
    num_nodes = terms["num_nodes"]
    if training and loss_type == "l2":
        if not norm_training_by_max_nodes:
            effective = num_nodes
        else:
            effective = torch.max(num_nodes) if max_num_nodes is None else max_num_nodes
        denom = (num_x_dims + num_node_scalar_features) * effective
        loss_t = 0.5 * (error_t / denom)
        loss_0 = terms["loss_0_x"] / denom + terms["loss_0_h"]
    else:
        loss_t = T * 0.5 * terms["SNR_weight"] * error_t
        loss_0 = terms["loss_0_x"] + terms["loss_0_h"] + terms["neg_log_constants"]
    nll = loss_t + loss_0 + terms["kl_prior"]
    nll = nll - terms["delta_log_px"]
    nll = nll - log_pN
    info = {
        "loss": nll.mean(), "loss_t": loss_t.mean(), "loss_0": loss_0.mean(),
        "SNR_weight": terms["SNR_weight"].mean(), "kl_prior": terms["kl_prior"].mean(),
        "delta_log_px": terms["delta_log_px"].mean(), "neg_log_const_0": terms["neg_log_constants"].mean(),
        "log_pN": log_pN.mean(), "eps_hat_x": terms["eps_hat_x"], "eps_hat_h": terms["eps_hat_h"],
    }
    return nll, info
