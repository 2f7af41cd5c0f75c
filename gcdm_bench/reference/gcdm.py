"""Plain PyTorch reference of GCDM: the GCPNet denoiser, the equivariant
diffusion's reverse step, decode and L2 training loss, and the optimizer
step (adaptive clip, AMSGrad, EMA).

Written from the equations of GCDM (Morehead & Cheng 2024) and its code
(BioinfoMachineLearning/bio-diffusion: ``src/models/components/gcpnet.py``,
``variational_diffusion.py``), for the configurations the benchmark runs:
GCP2 with sigmoid vector gates, bottlenecks, scalar message attention, a
residual message stack and one feedforward GCP.  Dense layout: molecules
``[B, N, .]`` with a node mask, every pair of real atoms an edge (self-loops
included).  It imports nothing of the program under test: parameter names
follow the published module tree, so one state dict loads into both.

The first message GCP reads ``[s_i | e_ij | s_j]``; a Linear over that
concat is evaluated per part (node parts once a node), which is the same
function with the FLOPs the inputs need.  It runs in the dtype of its
weights (float32, or float64 as the sampling check's judge); the caller
decides whether TF32 is allowed (the benchmark's control).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor
SV = 3  # frame projection channels


# -- geometry ------------------------------------------------------------------


def safe_norm(x: Tensor, dim: int) -> Tensor:
    return torch.sqrt((x * x).sum(dim=dim) + 1e-8) + 1e-8


def safe_normalize(x: Tensor) -> Tensor:
    sq = (x * x).sum(dim=-1, keepdim=True)
    pos = sq > 0
    return torch.where(pos, x / torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(x))


def guarded_sqrt(sq: Tensor) -> Tensor:
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(sq))


def remove_mean(x: Tensor, mask: Tensor) -> Tensor:
    """Zero centre of mass over the real atoms; padded rows stay as they are times 0 shift."""
    count = mask.sum(dim=-1, keepdim=True).clamp(min=1.0)
    centroid = (x * mask[..., None]).sum(dim=-2) / count
    return x - centroid[..., None, :] * mask[..., None]


def local_frames(x: Tensor, edge_mask: Tensor) -> Tensor:
    """``[B, N, N, 3, 3]``: rows a0 = dx / (|dx| + 1), a1 = x_i x x_j / (|.| + 1), a0 x a1."""
    xi, xj = x[:, :, None, :], x[:, None, :, :]
    diff = xi - xj
    cross = torch.cross(xi.expand_as(diff), xj.expand_as(diff), dim=-1)
    diff = diff / (guarded_sqrt((diff * diff).sum(-1, keepdim=True)) + 1.0)
    cross = cross / (guarded_sqrt((cross * cross).sum(-1, keepdim=True)) + 1.0)
    vert = torch.cross(diff, cross, dim=-1)
    return torch.stack([diff, cross, vert], dim=-2) * edge_mask[..., None, None]


def orientations(x: Tensor, mask: Tensor) -> Tensor:
    """Unit vectors to the next and the previous row, ``[B, N, 2, 3]``."""
    zero = torch.zeros_like(x[:, :1])
    nxt = torch.cat([x[:, 1:], zero], dim=1)
    prv = torch.cat([zero, x[:, :-1]], dim=1)
    return torch.stack([safe_normalize(nxt - x), safe_normalize(prv - x)], dim=-2) * mask[..., None, None]


def scalarize(v_cm: Tensor, frames: Tensor) -> Tensor:
    """Vectors ``[..., 3, C]`` on frames ``[..., 3(axis), 3]`` -> ``[..., C*3]`` (channel-major)."""
    out = torch.einsum("...ak,...kc->...ca", frames, v_cm)
    return out.reshape(out.shape[:-2] + (out.shape[-2] * 3,))


# -- GCP2 ----------------------------------------------------------------------


def act(name: Optional[str]):
    return F.silu if name == "silu" else (lambda t: t)


class GCP2(nn.Module):
    """Geometry-complete perceptron v2 with a sigmoid vector gate; vectors
    coords-major ``[..., 3, V]``."""

    def __init__(self, s_in: int, v_in: int, s_out: int, v_out: int, bottleneck: int = 1,
                 acts=("silu", "silu"), feedforward_out: bool = False):
        super().__init__()
        self.acts, self.v_out, self.ff_out = acts, v_out, feedforward_out
        hidden = v_in // bottleneck if bottleneck > 1 else max(v_in, v_out)
        self.vector_down = nn.Linear(v_in, hidden, bias=False)
        self.vector_down_frames = nn.Linear(v_in, SV, bias=False)
        merged = s_in + hidden + 3 * SV
        if feedforward_out:
            self.scalar_out = nn.Sequential(nn.Linear(merged, s_out), nn.SiLU(), nn.Linear(s_out, s_out))
        else:
            self.scalar_out = nn.Linear(merged, s_out)
        if v_out:
            self.vector_up = nn.Linear(hidden, v_out, bias=False)
            self.vector_out_scale = nn.Linear(s_out, v_out)

    def forward(self, s: Tensor, v_cm: Tensor, frames: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
        vh = self.vector_down(v_cm)
        merged = torch.cat([s, safe_norm(vh, -2), scalarize(self.vector_down_frames(v_cm), frames)], dim=-1)
        s_pre = self.scalar_out(merged)
        s_act, v_act = act(self.acts[0]), act(self.acts[1])
        if not self.v_out:
            return s_act(s_pre), None
        gate = torch.sigmoid(self.vector_out_scale(v_act(s_pre)))
        return s_act(s_pre), self.vector_up(vh) * gate[..., None, :]


class FirstMessage(nn.Module):
    """GCP2 over ``[s_i | e_ij | s_j]`` and ``[v_i | xi_ij | v_j]``, each Linear
    evaluated per part of its input columns."""

    def __init__(self, s: int, v: int, se: int, ve: int, bottleneck: int):
        super().__init__()
        self.dims = (s, v, se, ve)
        v_in = 2 * v + ve
        hidden = v_in // bottleneck
        self.vector_down = nn.Linear(v_in, hidden, bias=False)
        self.vector_down_frames = nn.Linear(v_in, SV, bias=False)
        self.scalar_out = nn.Linear(2 * s + se + hidden + 3 * SV, s)
        self.vector_up = nn.Linear(hidden, v, bias=False)
        self.vector_out_scale = nn.Linear(s, v)

    def forward(self, s: Tensor, v_cm: Tensor, e: Tensor, xi_cm: Tensor, frames: Tensor):
        sd, vd, sed, ved = self.dims

        def split_v(w):  # [out, 2V+Ve] over (v_i, xi_ij, v_j)
            return (F.linear(v_cm, w[:, :vd])[:, :, None] + F.linear(xi_cm, w[:, vd:vd + ved])
                    + F.linear(v_cm, w[:, vd + ved:])[:, None])

        vh = split_v(self.vector_down.weight)  # [B, N, N, 3, H]
        sc = scalarize(split_v(self.vector_down_frames.weight), frames)
        w, h = self.scalar_out.weight, vh.shape[-1]
        cols = np.cumsum([0, sd, sed, sd, h, 3 * SV])
        s_pre = (F.linear(s, w[:, cols[0]:cols[1]])[:, :, None] + F.linear(e, w[:, cols[1]:cols[2]])
                 + F.linear(s, w[:, cols[2]:cols[3]])[:, None] + F.linear(safe_norm(vh, -2), w[:, cols[3]:cols[4]])
                 + F.linear(sc, w[:, cols[4]:cols[5]]) + self.scalar_out.bias)
        gate = torch.sigmoid(self.vector_out_scale(F.silu(s_pre)))
        return F.silu(s_pre), self.vector_up(vh) * gate[..., None, :]


class MessagePassing(nn.Module):
    def __init__(self, s: int, v: int, se: int, ve: int, num_messages: int, bottleneck: int, default_bottleneck: int):
        super().__init__()
        fusion = [FirstMessage(s, v, se, ve, default_bottleneck)]
        fusion += [GCP2(s, v, s, v, bottleneck) for _ in range(num_messages - 2)]
        fusion.append(GCP2(s, v, s, v, default_bottleneck))
        self.message_fusion = nn.ModuleList(fusion)
        self.scalar_message_attention = nn.Sequential(nn.Linear(s, 1), nn.Sigmoid())

    def forward(self, s, v_cm, e, xi_cm, frames, edge_mask):
        ms, mv = self.message_fusion[0](s, v_cm, e, xi_cm, frames)
        for gcp in self.message_fusion[1:]:
            ds, dv = gcp(ms, mv, frames)
            ms, mv = ms + ds, mv + dv
        ms = ms * self.scalar_message_attention(ms)
        return (ms * edge_mask[..., None]).sum(dim=2), (mv * edge_mask[..., None, None]).sum(dim=2)


class Interaction(nn.Module):
    def __init__(self, s: int, v: int, se: int, ve: int, num_messages: int, bottleneck: int,
                 default_bottleneck: int):
        super().__init__()
        self.interaction = MessagePassing(s, v, se, ve, num_messages, bottleneck, default_bottleneck)
        self.feedforward_network = nn.ModuleList(
            [GCP2(2 * s, 2 * v, s, v, bottleneck, acts=(None, None), feedforward_out=True)])
        self.node_position_update_gcp = GCP2(s, v, s, 1, bottleneck)

    def forward(self, s, v_cm, e, xi_cm, frames, f_node, edge_mask, node_mask, x, positions_weight):
        agg_s, agg_v = self.interaction(s, v_cm, e, xi_cm, frames, edge_mask)
        ds, dv = self.feedforward_network[0](torch.cat([agg_s, s], -1), torch.cat([agg_v, v_cm], -1), f_node)
        s = (s + ds) * node_mask[..., None]
        v_cm = (v_cm + dv) * node_mask[..., None, None]
        _, upd = self.node_position_update_gcp(s, v_cm, f_node)
        x = (x + upd[..., 0] * positions_weight) * node_mask[..., None]
        return s, v_cm, x


class Embedding(nn.Module):
    def __init__(self, e_in, xi_in, se, ve, h_in, chi_in, s, v):
        super().__init__()
        self.edge_embedding = GCP2(e_in, xi_in, se, ve)
        self.node_embedding = GCP2(h_in, chi_in, s, v, acts=(None, None))


class Dynamics(nn.Module):
    """The eps-predicting GCPNet: ``(xh [B, N, 3+F], t [B, 1], mask [B, N]) -> [B, N, 3+F]``."""

    def __init__(self, model: Dict, module: Dict, layer: Dict, num_features: int):
        super().__init__()
        s, v, se, ve = (model[k] for k in ("h_hidden_dim", "chi_hidden_dim", "e_hidden_dim", "xi_hidden_dim"))
        self.num_features = num_features
        self.positions_weight = float(module["node_positions_weight"])
        h_in = num_features + 1  # atom types (+ charges) and time
        self.gcp_embedding = Embedding(model["e_input_dim"], model["xi_input_dim"], se, ve, h_in,
                                       model["chi_input_dim"], s, v)
        self.interaction_layers = nn.ModuleList([
            Interaction(s, v, se, ve, layer["mp_cfg"]["num_message_layers"], module["bottleneck"],
                        module["default_bottleneck"]) for _ in range(model["num_encoder_layers"])])
        self.scalar_node_projection_gcp = GCP2(s, v, h_in, 0, acts=(None, None))

    def forward(self, xh: Tensor, t: Tensor, mask: Tensor) -> Tensor:
        b, n = mask.shape
        xh = xh * mask[..., None]
        x0, h = xh[..., :3], xh[..., 3:]
        edge_mask = mask[:, :, None] * mask[:, None, :]
        chi = orientations(x0, mask).transpose(-1, -2)  # [B, N, 3, 2]
        diff = x0[:, :, None] - x0[:, None]
        e_s = (diff * diff).sum(-1, keepdim=True) * edge_mask[..., None]
        e_v = (safe_normalize(diff) * edge_mask[..., None])[..., None]  # [B, N, N, 3, 1]
        h = torch.cat([h, t[:, None, :].expand(b, n, 1)], dim=-1)
        x = remove_mean(x0, mask)
        frames = local_frames(x, edge_mask)
        f_node = frames.sum(dim=2) / edge_mask.sum(-1).clamp(min=1.0)[..., None, None]
        emb = self.gcp_embedding
        e, xi = emb.edge_embedding(e_s, e_v, frames)
        s, v_cm = emb.node_embedding(h, chi, f_node)
        for layer in self.interaction_layers:
            s, v_cm, x = layer(s, v_cm, e, xi, frames, f_node, edge_mask, mask, x, self.positions_weight)
        h_out, _ = self.scalar_node_projection_gcp(s, v_cm, f_node)
        vel = (x - x0) * mask[..., None]
        if not torch.isfinite(vel).all():
            vel = torch.zeros_like(vel)
        return torch.cat([remove_mean(vel, mask), h_out[..., :-1]], dim=-1)


# -- diffusion -------------------------------------------------------------------


def gamma_table(num_timesteps: int, power: float, precision: float) -> np.ndarray:
    """The polynomial schedule's gamma at k/T, k = 0..T (float64)."""
    steps = num_timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1.0 - np.power(x / steps, power)) ** 2
    alphas2 = np.concatenate([np.ones(1), alphas2])
    step = np.clip(alphas2[1:] / alphas2[:-1], 0.001, 1.0)
    alphas2 = (1.0 - 2.0 * precision) * np.cumprod(step) + precision
    return -(np.log(alphas2) - np.log(1.0 - alphas2))


class Diffusion:
    """The eps-parametrized E(3) diffusion over one ``Dynamics``."""

    def __init__(self, dynamics: Dynamics, diffusion: Dict, include_charges: bool, num_types: int, device,
                 dtype=torch.float32):
        self.net, self.include_charges, self.num_types = dynamics, include_charges, num_types
        self.T = int(diffusion["num_timesteps"])
        power = float(diffusion["noise_schedule"].split("_")[1])
        self.table = torch.tensor(gamma_table(self.T, power, float(diffusion["noise_precision"])),
                                  dtype=dtype, device=device)
        self.norm_values = [float(v) for v in diffusion["norm_values"]]

    def gamma(self, t: Tensor) -> Tensor:
        return self.table[torch.clamp(torch.round(t * self.T).long(), 0, self.T)]

    def noise(self, raw: Tensor, mask: Tensor) -> Tensor:
        """Raw normal draws -> CoM-free positions and masked features."""
        m = mask[..., None]
        return torch.cat([remove_mean(raw[..., :3] * m, mask), raw[..., 3:] * m], dim=-1)

    def reverse_step(self, z: Tensor, s: Tensor, t: Tensor, mask: Tensor, raw: Tensor) -> Tensor:
        g_s, g_t = self.gamma(s), self.gamma(t)
        sigma2_tgs = -torch.expm1(F.softplus(g_s) - F.softplus(g_t))
        alpha_tgs = torch.exp(0.5 * (F.logsigmoid(-g_t) - F.logsigmoid(-g_s)))
        sigma_s, sigma_t = torch.sqrt(torch.sigmoid(g_s)), torch.sqrt(torch.sigmoid(g_t))
        eps = self.net(z, t, mask)
        mu = z / alpha_tgs[..., None] - (sigma2_tgs / alpha_tgs / sigma_t)[..., None] * eps
        zs = mu + (torch.sqrt(sigma2_tgs) * sigma_s / sigma_t)[..., None] * self.noise(raw, mask)
        return torch.cat([remove_mean(zs[..., :3], mask), zs[..., 3:]], dim=-1)

    def decode(self, z: Tensor, mask: Tensor, raw: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """-> (positions, continuous types, continuous charges) on the data scale, before rounding."""
        t0 = torch.zeros((z.shape[0], 1), dtype=z.dtype, device=z.device)
        g0 = self.gamma(t0)
        eps = self.net(z, t0, mask)
        mu = (z - torch.sqrt(torch.sigmoid(g0))[..., None] * eps) / torch.sqrt(torch.sigmoid(-g0))[..., None]
        xh = mu + torch.exp(0.5 * g0)[..., None] * self.noise(raw, mask)
        m = mask[..., None]
        k = self.num_types
        x = remove_mean(xh[..., :3] * self.norm_values[0], mask)
        h_cat = xh[..., 3:3 + k] * self.norm_values[1] * m
        h_int = xh[..., 3 + k:] * self.norm_values[2] * m
        return x, h_cat, h_int

    def sample(self, mask: Tensor, draws: Tensor, num_steps: int):
        """Prior, ``num_steps`` reverse steps over [0, 1], decode; ``draws [num_steps + 2, B, N, 3+F]``."""
        b = mask.shape[0]
        z = self.noise(draws[0], mask)
        for k, s_int in enumerate(range(num_steps - 1, -1, -1)):
            s = torch.full((b, 1), s_int / num_steps, dtype=torch.float32, device=mask.device)
            t = torch.full((b, 1), (s_int + 1) / num_steps, dtype=torch.float32, device=mask.device)
            z = self.reverse_step(z, s, t, mask, draws[1 + k])
        return self.decode(z, mask, draws[-1])

    def l2_nll(self, x: Tensor, one_hot: Tensor, charges: Tensor, mask: Tensor, t_int: Tensor, eps_raw: Tensor,
               log_pn: Tensor) -> Tensor:
        """The per-molecule training objective of the L2 loss (``[B]``); ``x`` CoM-free."""
        m = mask[..., None]
        nv = self.norm_values
        h_cat = one_hot / nv[1] * m
        h_int = charges / nv[2] * (m if self.include_charges else 1.0)
        xh = torch.cat([x / nv[0], h_cat] + ([h_int] if self.include_charges else []), dim=-1)
        t_int = t_int.float()
        t = t_int / self.T
        g_t = self.gamma(t)
        alpha_t, sigma_t = torch.sqrt(torch.sigmoid(-g_t))[..., None], torch.sqrt(torch.sigmoid(g_t))[..., None]
        eps = self.noise(eps_raw, mask)
        z_t = alpha_t * xh + sigma_t * eps
        net = self.net(z_t, t, mask)
        t0 = (t_int == 0).float()[..., 0]
        error = ((eps - net) ** 2).sum(dim=(-1, -2)) * (1.0 - t0)
        num_nodes = mask.sum(-1)
        # KL(q(z_T | x) || N(0, 1)), the h part integrated with d = 1 as in the reference
        g_T = self.gamma(torch.ones_like(t))
        alpha_T, sigma_T = torch.sqrt(torch.sigmoid(-g_T)), torch.sqrt(torch.sigmoid(g_T))[..., 0]
        mu_T = alpha_T[..., None] * xh

        def kl(mu2, d):
            return d * torch.log(1.0 / sigma_T) + 0.5 * (d * sigma_T ** 2 + mu2) - 0.5 * d

        kl_prior = kl((mu_T[..., :3] ** 2).sum((-1, -2)), (num_nodes - 1) * 3) \
            + kl(((mu_T[..., 3:] ** 2) * m).sum((-1, -2)), 1.0)
        # L0 at t = 0: the position likelihood and the type / charge likelihoods
        log_p_x = -0.5 * ((eps[..., :3] - net[..., :3]) ** 2).sum((-1, -2))
        sigma_0 = torch.sqrt(torch.sigmoid(g_t))[..., None]
        k = self.num_types
        cdf = lambda v: 0.5 * (1.0 + torch.erf(v / math.sqrt(2.0)))  # noqa: E731
        est_cat = z_t[..., 3:3 + k] * nv[1] - 1.0
        s_cat = sigma_0 * nv[1]
        log_cat = torch.log(cdf((est_cat + 0.5) / s_cat) - cdf((est_cat - 0.5) / s_cat) + 1e-10)
        log_cat = log_cat - torch.logsumexp(log_cat, dim=-1, keepdim=True)
        log_p_h = (log_cat * (h_cat * nv[1]) * m).sum((-1, -2))
        if self.include_charges:
            s_int = sigma_0 * nv[2]
            centered = torch.round(h_int * nv[2]) - z_t[..., 3 + k:] * nv[2]
            log_int = torch.log(cdf((centered + 0.5) / s_int) - cdf((centered - 0.5) / s_int) + 1e-10)
            log_p_h = log_p_h + (log_int * m).sum((-1, -2))
        denom = (3 + self.num_types + int(self.include_charges)) * num_nodes
        loss_t = 0.5 * error / denom
        loss_0 = -log_p_x * t0 / denom - log_p_h * t0
        return loss_t + loss_0 + kl_prior - log_pn


# -- optimizer -------------------------------------------------------------------


class Optimizer:
    """Adaptive gradient clip (1.5 mean + 2 std of the recent clipped norms,
    a queue of 50 seeded with 3000), AMSGrad with coupled weight decay, EMA."""

    def __init__(self, params: Sequence[Tensor], lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, ema_decay: float):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps, self.wd, self.ema_decay = lr, b1, b2, eps, weight_decay, ema_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]
        self.ema = [p.detach().clone() for p in self.params]
        self.queue: List[float] = [3000.0]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[Tensor]) -> None:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()
        filled = np.array(self.queue[-50:], dtype=np.float64)
        max_norm = 1.5 * filled.mean() + 2.0 * filled.std()
        coef = max_norm / (norm + 1e-6)
        scale = coef if coef < 1.0 else 1.0
        self.queue.append(min(norm, max_norm))
        self.count += 1
        for p, g, mu, nu, nm, e in zip(self.params, grads, self.mu, self.nu, self.nu_max, self.ema):
            g = g * scale
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            nm.copy_(torch.maximum(nm, nu / (1.0 - self.b2 ** self.count)))
            update = (mu / (1.0 - self.b1 ** self.count)) / (torch.sqrt(nm) + self.eps) + self.wd * p
            p.sub_(self.lr * update)
            e.mul_(self.ema_decay).add_(p, alpha=1.0 - self.ema_decay)
