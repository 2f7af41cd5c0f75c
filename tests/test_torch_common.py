"""Shared builders for the PyTorch port's parity tests (no tests of its own).

The port (``bio_diffusion_torch``) is held against the JAX package at a tiny
width: the same numpy-seeded inputs and the same JAX-initialized weights go
through both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bio_diffusion_torch.config import schema as port_schema
from bio_diffusion_tpu.config import schema as jax_schema

# S=16, V=4, Se=8, Ve=2, two layers, T=10
TINY_OVERRIDES = [
    "datamodule.dataloader_cfg.dataset=synthetic",
    "model.model_cfg.h_hidden_dim=16",
    "model.model_cfg.chi_hidden_dim=4",
    "model.model_cfg.e_hidden_dim=8",
    "model.model_cfg.xi_hidden_dim=2",
    "model.model_cfg.num_encoder_layers=2",
    "model.diffusion_cfg.num_timesteps=10",
]


def _tiny(schema):
    mc = schema.ModelConfig(h_hidden_dim=16, chi_hidden_dim=4, e_hidden_dim=8, xi_hidden_dim=2,
                            num_encoder_layers=2)
    return (mc, schema.ModuleConfig(), schema.LayerConfig(), schema.DiffusionConfig(num_timesteps=10),
            schema.DataloaderConfig())


def tiny_configs():
    """The tiny (model, module, layer, diffusion, dataloader) configs of the port."""
    return _tiny(port_schema)


def jax_tiny_configs():
    """The same configs as the JAX package's dataclasses, for its models."""
    return _tiny(jax_schema)


def tiny_batch(b=2, n=7, seed=0):
    """Numpy-seeded (xh [B, N, 9], t [B, 1], node_mask [B, N]); molecule 1
    has two padded rows; positions CoM-free."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), np.float32)
    mask[1, n - 2:] = 0
    x = rng.normal(size=(b, n, 3)).astype(np.float32) * mask[..., None]
    x -= (x.sum(1, keepdims=True) / mask.sum(1)[:, None, None]) * mask[..., None]
    h = rng.normal(size=(b, n, 6)).astype(np.float32) * mask[..., None]
    t = np.full((b, 1), 0.7, np.float32)
    return np.concatenate([x, h], -1), t, mask


def build_jax_and_port(seed=0):
    """JAX GCPNetDynamics + EVD with initialized params, and the port's EVD
    carrying the same weights (float32, CPU); ``cfgs`` are the port's."""
    from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
    from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
    from bio_diffusion_torch.train.torch_import import (
        load_reference_state_dict, state_dict_from_jax_params,
    )

    cfgs = tiny_configs()
    mc, mod, lc, dc, dl = jax_tiny_configs()
    net = JaxDynamics(mc, mod, lc, dc, dl, remat_interactions=False)
    xh, t, mask = tiny_batch()
    dyn_params = net.init(jax.random.PRNGKey(seed), jnp.asarray(xh), jnp.asarray(t), jnp.asarray(mask))
    evd_params = {"params": {"dynamics": dyn_params["params"]}}
    jax_evd = JaxEVD(dynamics=net, diffusion_cfg=dc, dataloader_cfg=dl)

    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    load_reference_state_dict(evd, state_dict_from_jax_params(evd_params))
    return cfgs, net, dyn_params, jax_evd, evd_params, evd.eval()


def t32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))
