"""Port parity: the reverse diffusion process against the JAX EVD.

Random streams differ between the frameworks, so the JAX draws are
reproduced by splitting keys exactly as ``reverse_segment`` and
``sample_noise`` do, and handed to the port as raw noise.  Float32, CPU:
positions within atol 1e-4, decoded one-hot and charges identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import build_jax_and_port, tiny_batch

ATOL = 1e-4
NUM_FEATURES = 6  # 5 atom types + charge


def jax_raw_noise(key, b, n):
    """The standard-normal draws ``EVD.sample_noise(key, ...)`` makes."""
    kx, kh = jax.random.split(key)
    zx = jax.random.normal(kx, (b, n, 3))
    zh = jax.random.normal(kh, (b, n, NUM_FEATURES))
    return torch.from_numpy(np.concatenate([np.asarray(zx), np.asarray(zh)], -1))


@pytest.fixture(scope="module")
def models():
    return build_jax_and_port(seed=3)


def test_gamma_schedule_matches(models):
    *_, jax_evd, evd_params, evd = models
    # 0.25 and 0.35 land on .5 at T=10: both round half to even
    t = np.array([[0.0], [0.0005], [0.25], [0.35], [0.95], [1.0]], np.float32)
    g_j = jax_evd.apply(evd_params, jnp.asarray(t), method=jax_evd.gamma)
    np.testing.assert_allclose(evd.gamma(torch.from_numpy(t)).numpy(), np.asarray(g_j), rtol=0, atol=0)
    ref = jax_evd.sigma_and_alpha_t_given_s(g_j[1:], g_j[:-1])
    ours = evd.sigma_and_alpha_t_given_s(evd.gamma(torch.from_numpy(t[1:])), evd.gamma(torch.from_numpy(t[:-1])))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_one_reverse_step_matches(models):
    *_, jax_evd, evd_params, evd = models
    xh, _, mask = tiny_batch(seed=4)
    b, n = mask.shape
    s = np.full((b, 1), 0.6, np.float32)
    t = np.full((b, 1), 0.7, np.float32)
    key = jax.random.PRNGKey(5)
    z_j = jax_evd.apply(evd_params, jnp.asarray(s), jnp.asarray(t), jnp.asarray(xh),
                        jnp.asarray(mask), key, method=jax_evd.sample_p_zs_given_zt)
    with torch.inference_mode():
        z_t = evd.sample_p_zs_given_zt(torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(xh),
                                       torch.from_numpy(mask), noise=jax_raw_noise(key, b, n))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=ATOL, rtol=0)


def test_ten_step_chain_and_decode_match(models):
    *_, jax_evd, evd_params, evd = models
    _, _, mask = tiny_batch(seed=6)
    b, n = mask.shape
    T = evd.T
    s_vals = np.arange(T - 1, -1, -1, dtype=np.float32) / T
    t_vals = (np.arange(T - 1, -1, -1, dtype=np.float32) + 1) / T
    jm = jnp.asarray(mask)

    # JAX: prior, one scanned segment of T steps, decode (SegmentedSampler.run's key splits)
    key = jax.random.PRNGKey(7)
    key, k_init = jax.random.split(key)
    z0_j = jax_evd.apply(evd_params, k_init, jm, method=jax_evd.init_sample_noise)
    key, k_seg = jax.random.split(key)
    zT_j, _, _ = jax_evd.apply(evd_params, z0_j, None, k_seg, jnp.asarray(s_vals), jnp.asarray(t_vals),
                               jm, method=jax_evd.reverse_segment)
    key, k_dec = jax.random.split(key)
    xh_j = np.asarray(jax_evd.apply(evd_params, zT_j, None, k_dec, jm, method=jax_evd.decode_sample))

    # the same draws for the port: reverse_segment splits (key, k1, k2) per step
    step_noises, carry = [], k_seg
    for _ in range(T):
        carry, k1, _ = jax.random.split(carry, 3)
        step_noises.append(jax_raw_noise(k1, b, n))
    tm = torch.from_numpy(mask)
    with torch.inference_mode():
        z = evd.init_sample_noise(tm, noise=jax_raw_noise(k_init, b, n))
        np.testing.assert_allclose(z.numpy(), np.asarray(z0_j), atol=1e-6, rtol=0)
        z, _ = evd.reverse_segment(z, s_vals, t_vals, tm, noises=step_noises)
        np.testing.assert_allclose(z.numpy()[..., :3], np.asarray(zT_j)[..., :3], atol=ATOL, rtol=0)
        xh = evd.decode_sample(z, tm, noise=jax_raw_noise(k_dec, b, n)).numpy()

    np.testing.assert_allclose(xh[..., :3], xh_j[..., :3], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(xh[..., 3:], xh_j[..., 3:])  # one-hot and charges
    real = mask > 0
    assert np.all(xh[~real] == 0)
    assert np.all(xh[..., 3:8][real].sum(-1) == 1)


@pytest.mark.parametrize("schedule", ["polynomial_2", "polynomial_3", "cosine"])
def test_gamma_table_copy_matches(schedule):
    from bio_diffusion_tpu.ops.schedules import predefined_gamma_table as jax_table
    from bio_diffusion_torch.ops.schedules import predefined_gamma_table

    np.testing.assert_array_equal(predefined_gamma_table(schedule, 1000, 1e-5),
                                  jax_table(schedule, 1000, 1e-5))
