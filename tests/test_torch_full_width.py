"""Port parity at full width: the ``config/schema.py`` default denoiser (9
layers, S=256, V=32, Se=64, Ve=16) in a 10-step reverse chain (the first
10 steps of T=1000) and its decode, against the JAX package.

The other parity tests hold the denoiser at the tiny width (S=16, 2
layers).  Here ``experiment=qm9_mol_gen_ddpm`` at its published widths with
T=1000, B=2, N=19 (molecule 1 with 3 padded rows), float32 on the CPU (the
port's plain message layer, the JAX module path); the weights are drawn by
the port from a seed and carried into JAX by its reference-name import;
JAX's draws (``SegmentedSampler.run``'s key splits) are passed to the port.
Tolerance: the state's positions after 10 steps and the decoded positions
within 1e-4 absolute (measured: 4.8e-6), the state's features within 1e-4
or 1e-5 of their max|JAX|, whichever is larger (the weights drawn by the
port grow them to ~460 in 10 steps; measured 4.6e-4, 1e-6 of max: float32
rounding), the decoded one-hot and charges identical.  (A chain of T=10 grows seed
weights' h to ~1e7 in 10 steps, where float32 rounding alone exceeds any
absolute bound.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

ATOL = 1e-4
TOL_REL = 1e-5  # of max|JAX| on the features, which seed weights grow to ~460 in these 10 steps
OVERRIDES = ["experiment=qm9_mol_gen_ddpm", "datamodule.dataloader_cfg.dataset=synthetic"]


def test_full_width_ten_step_chain_matches_jax():
    from bio_diffusion_tpu.config.build import build_evd as jax_build_evd
    from bio_diffusion_tpu.config.build import build_experiment as jax_build_experiment
    from bio_diffusion_tpu.config.loader import load_config as jax_load_config
    from bio_diffusion_tpu.train.torch_import import import_state_dict
    from bio_diffusion_torch.config import schema
    from bio_diffusion_torch.config.build import build_evd, build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.train.sampling import make_node_mask
    from bio_diffusion_torch.train.torch_import import init_random_weights
    from test_torch_diffusion import jax_raw_noise

    exp = build_experiment(load_config(default_config_dir(), "train", OVERRIDES))
    jexp = jax_build_experiment(jax_load_config(default_config_dir(), "train", OVERRIDES))
    mc, default = exp.model_cfg, schema.ModelConfig()
    widths = (mc.num_encoder_layers, mc.h_hidden_dim, mc.chi_hidden_dim, mc.e_hidden_dim, mc.xi_hidden_dim)
    assert widths == (9, 256, 32, 64, 16) == (default.num_encoder_layers, default.h_hidden_dim,
                                             default.chi_hidden_dim, default.e_hidden_dim, default.xi_hidden_dim)

    evd = build_evd(exp)
    init_random_weights(evd, 0)
    evd_j = jax_build_evd(jexp, remat=False)
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((2, 6, 3))
    shapes = jax.eval_shape(lambda: evd_j.init(key, x0, jnp.zeros((2, 6, 5)), jnp.zeros((2, 6, 1)),
                                               jnp.ones((2, 6)), key, training=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = jax.tree.map(jnp.asarray, import_state_dict(
        {"ddpm." + k: v.numpy() for k, v in evd.state_dict().items()}, template))

    # the first 10 reverse steps of the T=1000 chain (s = 999 .. 990), then the decode
    n, b = 19, 2
    mask = make_node_mask(np.array([19, 16]), n)
    jm = jnp.asarray(mask)
    s_vals = np.arange(999, 989, -1, dtype=np.float32)
    s_norm, t_norm = s_vals / evd.T, (s_vals + 1) / evd.T
    key = jax.random.PRNGKey(7)
    key, k_init = jax.random.split(key)
    key, k_seg = jax.random.split(key)
    key, k_dec = jax.random.split(key)
    run = jax.jit(lambda p, k0, ks, kd, m: _jax_chain(evd_j, p, k0, ks, kd, m, s_norm, t_norm))
    z0_j, z_j, xh_j = (np.asarray(a) for a in run(params, k_init, k_seg, k_dec, jm))

    draws, carry = [], k_seg
    for _ in range(len(s_vals)):
        carry, k1, _ = jax.random.split(carry, 3)
        draws.append(jax_raw_noise(k1, b, n))
    tm = torch.from_numpy(mask)
    evd.eval()
    with torch.inference_mode():
        z = evd.init_sample_noise(tm, noise=jax_raw_noise(k_init, b, n))
        np.testing.assert_allclose(z.numpy(), z0_j, rtol=0, atol=1e-6)
        frames = torch.empty((len(s_vals),) + z.shape)
        z, _ = evd.reverse_segment(z, s_norm, t_norm, tm, noises=draws, frames=frames,
                                frame_steps=range(len(s_vals)))
        np.testing.assert_allclose(z.numpy()[..., :3], z_j[..., :3], rtol=0, atol=ATOL)
        h_scale = float(np.abs(z_j[..., 3:]).max())
        np.testing.assert_allclose(z.numpy()[..., 3:], z_j[..., 3:], rtol=0, atol=max(ATOL, TOL_REL * h_scale))
        np.testing.assert_array_equal(frames[-1].numpy(), evd.unnormalize_z(z, tm).numpy())
        xh = evd.decode_sample(z, tm, noise=jax_raw_noise(k_dec, b, n)).numpy()
    np.testing.assert_allclose(xh[..., :3], xh_j[..., :3], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(xh[..., 3:], xh_j[..., 3:])
    assert np.all(xh[1, 16:] == 0) and np.all(xh[..., 3:8][mask > 0].sum(-1) == 1)


def _jax_chain(evd_j, params, k_init, k_seg, k_dec, mask, s_norm, t_norm):
    """JAX: the prior, one scanned segment of reverse steps, the decode."""
    z0 = evd_j.apply(params, k_init, mask, method=evd_j.init_sample_noise)
    z, _, _ = evd_j.apply(params, z0, None, k_seg, jnp.asarray(s_norm), jnp.asarray(t_norm), mask,
                          method=evd_j.reverse_segment)
    return z0, z, evd_j.apply(params, z, None, k_dec, mask, method=evd_j.decode_sample)
