"""Port parity: weights carried across, and the full GCPNet denoiser.

* The port's JAX-params -> state_dict mapping equals the JAX package's
  ``export_state_dict`` key for key and value for value, and loads into the
  port's EVD with ``strict=True``; a reference-style ``.ckpt`` loads too.
* The port's ``GCPNetDynamics`` (float32, CPU: plain message layers) against
  JAX ``make_fast_dynamics(..., compute_dtype=None, use_pallas=True,
  interpret=True)`` and the JAX module path on the same params: atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.models.gcpnet_fast import make_fast_dynamics
from bio_diffusion_tpu.train.torch_import import export_state_dict
from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
from bio_diffusion_torch.train.torch_import import (
    load_reference_checkpoint, load_reference_state_dict, state_dict_from_jax_params,
)
from test_torch_common import build_jax_and_port, tiny_batch

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    return build_jax_and_port()


def test_state_dict_mapping_matches_export(models):
    _, _, _, _, evd_params, evd = models
    ours = state_dict_from_jax_params(evd_params)
    ref = export_state_dict(evd_params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape and np.array_equal(ours[k], ref[k]), k
    # every port parameter is named by the mapping (the load is strict)
    port_keys = {"ddpm." + k for k in evd.state_dict()}
    assert port_keys == set(ours)


def test_reference_checkpoint_loads(models, tmp_path):
    cfgs, _, _, _, evd_params, evd = models
    sd = {k: torch.from_numpy(np.array(v)) + 1.0 for k, v in state_dict_from_jax_params(evd_params).items()}
    sd["ddpm.gamma.gamma"] = torch.zeros(11)  # reference schedule buffer: not a parameter here
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    fresh = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    load_reference_checkpoint(fresh, str(path))
    got = fresh.state_dict()
    for k, v in evd.state_dict().items():
        assert torch.equal(got[k], v + 1.0), k
    sd.pop("ddpm.dynamics_network.scalar_node_projection_gcp.scalar_out.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_state_dict(fresh, sd)


def test_denoiser_matches_jax(models):
    cfgs, net, dyn_params, _, _, evd = models
    mc, mod, lc, dc, dl = cfgs
    xh, t, mask = tiny_batch(seed=1)
    expected_module = np.asarray(net.apply(dyn_params, jnp.asarray(xh), jnp.asarray(t), jnp.asarray(mask)))
    fast = make_fast_dynamics(mc, mod, lc, dc, dl, {"params": {"dynamics": dyn_params["params"]}},
                              compute_dtype=None, use_pallas=True, interpret=True)
    expected_kernel = np.asarray(fast(jnp.asarray(xh), jnp.asarray(t), jnp.asarray(mask)))
    with torch.inference_mode():
        out = evd.dynamics_network(torch.from_numpy(xh), torch.from_numpy(t),
                                   torch.from_numpy(mask)).numpy()
    assert out.shape == xh.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, expected_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, expected_module, atol=ATOL, rtol=0)
    assert np.all(out[mask == 0][:, :3] == 0)  # velocity on padded rows (eps_h is not masked)


def test_denoiser_bf16_body_runs_on_cpu(models):
    """The bf16 serving body on the CPU: finite, close to the f32 body at
    bf16 precision (rel 5e-2 of max|f32|), f32 output."""
    cfgs, _, _, _, _, evd = models
    bf = GCPNetDynamics(*cfgs, compute_dtype="bfloat16")
    bf.load_state_dict(evd.dynamics_network.state_dict())
    xh, t, mask = (torch.from_numpy(a) for a in tiny_batch(seed=2))
    with torch.inference_mode():
        ref = evd.dynamics_network(xh, t, mask)
        out = bf(xh, t, mask)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 5e-2 * ref.abs().max()


def test_unsupported_configuration_raises(models):
    import dataclasses

    mc, mod, lc, dc, dl = models[0]
    with pytest.raises(NotImplementedError):
        GCPNetDynamics(mc, dataclasses.replace(mod, selected_gcp="gcp"), lc, dc, dl)
    with pytest.raises(NotImplementedError):
        GCPNetDynamics(mc, mod, lc, dataclasses.replace(dc, self_condition=True), dl)
