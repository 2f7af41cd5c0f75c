"""Port parity: the module-path GCPNet denoiser, against the JAX package.

The tiny QM9 model of ``test_torch_common`` (S=16, V=4, Se=8, Ve=2, 2
layers, T=10; 3 message GCPs a layer unless a case says otherwise) in the
configurations the packed forward does not take, one parametrised case for
each group of options (``CASES``); between them they cover GCP v1 with the
sigma frame gate and with the frame gate and its residual, GCP2's frame
gate, its norm gate (the fused first message GCP's too), vector residuals,
each ablation (the materialized message concat), GCP norm before and after,
a plain message stack without attention, 2 and 3 feedforward GCPs, the
vector-sum position update, relu, leakyrelu, selu and sigmoid,
self-conditioning with a property context and GCP dropout (deterministic),
and a bf16 body.  The weights are drawn by the port from a seed and carried
into JAX through the JAX package's strict reference-name import (its
template by ``jax.eval_shape``); the inputs come from numpy (B=2, N=7, two
padded rows).  CPU: JAX's flax module path (``GCPNetDynamics``), the port's
module forward.

* The denoiser's output: atol 1e-4 in float32; in bf16 within 1e-2 of
  max|output|, as ``test_torch_denoiser.py`` holds the packed bf16 body.
* The gradients of ``sum(out * w)`` (w fixed, from numpy) with respect to
  every parameter against ``jax.grad``: within 1e-4 of the largest gradient
  (float32), 2e-2 in bf16.
* The weight mapping: ``state_dict_from_jax_params`` equals JAX's
  ``export_state_dict`` and loads strictly; a reference-style ``.ckpt`` of a
  module-path configuration loads.
* Port only: the shipped configuration's module forward equals its packed
  forward (plain versions), output and gradients; ``GCP2FusedEdgeMessage``
  equals a plain GCP2 on the materialized concat; the path is chosen by
  configuration and ``trainer.fast_train``; a configuration JAX cannot build
  (``default_vector_residual``) and an unknown nonlinearity raise in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics
from bio_diffusion_tpu.train.torch_import import export_state_dict, import_state_dict
from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
from bio_diffusion_torch.models.gcpnet import GCPNetDynamics, supports_fast_path
from bio_diffusion_torch.train.torch_import import (
    init_random_weights,
    load_reference_checkpoint,
    load_reference_state_dict,
    state_dict_from_jax_params,
)
from test_torch_common import jax_tiny_configs, tiny_batch, tiny_configs

ATOL = 1e-4
GRAD_REL = 1e-4  # of the largest gradient
BF16_REL = {"out": 1e-2, "grad": 2e-2}

# each case: fields to set on the (model, module, layer, message-passing,
# diffusion) configs, and the body's precision
CASES = {
    "v1_sigma_frame_gate_relu": dict(module=dict(selected_gcp="gcp", sigma_frame_gate=True,
                                                 scalar_nonlinearity="relu", vector_nonlinearity="relu")),
    "v1_frame_gate_residual_prenorm_leakyrelu": dict(
        module=dict(selected_gcp="gcp", frame_gate=True, vector_frame_residual=True,
                    scalar_nonlinearity="leakyrelu", vector_nonlinearity="leakyrelu"),
        layer=dict(use_gcp_norm=True, pre_norm=True)),
    "gcp2_frame_gate_ff2_vector_sum_selu": dict(
        module=dict(frame_gate=True, update_positions_with_vector_sum=True, scalar_nonlinearity="selu",
                    vector_nonlinearity="selu"),
        layer=dict(num_feedforward_layers=2)),
    "gcp2_norm_gate_postnorm_ff3_sigmoid": dict(
        module=dict(vector_gate=False, scalar_nonlinearity="sigmoid", vector_nonlinearity="sigmoid"),
        layer=dict(use_gcp_norm=True, pre_norm=False, num_feedforward_layers=3)),
    "plain_stack_no_attention": dict(layer=dict(use_scalar_message_attention=False),
                                     mp=dict(use_residual_message_gcp=False, num_message_layers=1)),
    # a vector residual adds a GCP's input vectors to its outputs: every GCP
    # it reaches (embeddings, message and middle feedforward GCPs) keeps V
    # (and no bottleneck leaves a GCP without hidden channels)
    "vector_residual_ff3": dict(model=dict(chi_hidden_dim=2, xi_hidden_dim=1),
                                module=dict(vector_residual=True, bottleneck=1, default_bottleneck=1),
                                layer=dict(num_feedforward_layers=3)),
    "ablate_scalars": dict(module=dict(ablate_scalars=True)),
    "ablate_vectors": dict(module=dict(ablate_vectors=True)),
    "ablate_frame_updates": dict(module=dict(ablate_frame_updates=True)),
    "self_condition_context_dropout": dict(
        model=dict(dropout=0.1), module=dict(conditioning=("alpha",)), layer=dict(use_gcp_dropout=True),
        diffusion=dict(self_condition=True)),
    "bf16_frame_gate": dict(module=dict(frame_gate=True), precision="bfloat16"),
}


def configure(cfgs, spec):
    """The tiny configs with ``spec``'s fields set (3 message GCPs by default)."""
    mc, mod, lc, dc, dl = cfgs
    mp = dataclasses.replace(lc.mp_cfg, **{"num_message_layers": 3, **spec.get("mp", {})})
    return (dataclasses.replace(mc, **spec.get("model", {})), dataclasses.replace(mod, **spec.get("module", {})),
            dataclasses.replace(lc, mp_cfg=mp, **spec.get("layer", {})),
            dataclasses.replace(dc, **spec.get("diffusion", {})), dl)


class Case:
    """The port's module-path denoiser and JAX's with the same weights, the
    numpy inputs, and both sides' output and parameter gradients."""

    def __init__(self, name, seed=1):
        spec = CASES[name]
        self.cfgs, jcfgs = configure(tiny_configs(), spec), configure(jax_tiny_configs(), spec)
        self.precision = spec.get("precision")
        self.evd = EquivariantVariationalDiffusion(GCPNetDynamics(*self.cfgs, compute_dtype=self.precision),
                                                   self.cfgs[3], self.cfgs[4])
        init_random_weights(self.evd, seed)
        dyn = self.evd.dynamics_network
        assert not dyn.packed
        xh, t, mask = tiny_batch()
        rng = np.random.default_rng(seed)
        b = mask.shape[0]
        kw = {}
        if jcfgs[3].self_condition:
            kw["xh_self_cond"] = (rng.normal(size=xh.shape) * mask[..., None]).astype(np.float32)
        if jcfgs[1].conditioning:
            kw["context"] = (rng.normal(size=(b, 1, 1)) * mask[..., None]).astype(np.float32)
        w = rng.normal(size=xh.shape).astype(np.float32)

        net = JaxDynamics(*jcfgs, remat_interactions=False, compute_dtype=self.precision)
        j_in = [jnp.asarray(a) for a in (xh, t, mask)]
        j_kw = {k: jnp.asarray(v) for k, v in kw.items()}
        shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), *j_in, **j_kw))
        template = {"params": {"dynamics": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])}}
        sd = {"ddpm." + k: v.numpy() for k, v in self.evd.state_dict().items()}
        self.jax_params = import_state_dict(sd, template)  # strict: the port's tree is JAX's

        def loss(p):
            out = net.apply({"params": p}, *j_in, **j_kw)
            return jnp.sum(out.astype(jnp.float32) * w), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree.map(jnp.asarray, self.jax_params["params"]["dynamics"]))
        self.jax_out = np.asarray(out, np.float32)
        prefix = "ddpm.dynamics_network."
        self.jax_grads = {k[len(prefix):]: v for k, v in
                          export_state_dict({"params": {"dynamics": jax.device_get(grads)}}).items()}

        t_kw = {k: torch.from_numpy(v) for k, v in kw.items()}
        out = dyn(*(torch.from_numpy(a) for a in (xh, t, mask)), **t_kw)
        names = [k for k, _ in dyn.named_parameters()]
        # (a norm-gated position update's scalar path reaches no output: zero gradients, as in JAX)
        g = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [p for _, p in dyn.named_parameters()],
                                allow_unused=True, materialize_grads=True)
        self.out = out.detach().numpy()
        self.grads = {k: v.numpy() for k, v in zip(names, g)}


_CASES = {}


def case(name):
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


@pytest.mark.parametrize("name", list(CASES))
def test_module_forward_matches_jax(name):
    c = case(name)
    assert np.isfinite(c.out).all()
    atol = ATOL if c.precision is None else BF16_REL["out"] * np.abs(c.jax_out).max()
    np.testing.assert_allclose(c.out, c.jax_out, rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_module_gradients_match_jax(name):
    c = case(name)
    assert sorted(c.grads) == sorted(c.jax_grads)
    scale = max(np.abs(g).max() for g in c.jax_grads.values())
    rel = GRAD_REL if c.precision is None else BF16_REL["grad"]
    for k, g in c.grads.items():
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, c.jax_grads[k], rtol=0, atol=rel * scale, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_weight_mapping_matches_export(name):
    c = case(name)
    ours, ref = state_dict_from_jax_params(c.jax_params), export_state_dict(c.jax_params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape and np.array_equal(ours[k], ref[k]), k
    fresh = EquivariantVariationalDiffusion(GCPNetDynamics(*c.cfgs), c.cfgs[3], c.cfgs[4])
    load_reference_state_dict(fresh, ours)  # strict
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), c.evd.state_dict()[k].numpy(), err_msg=k)


def test_reference_checkpoint_of_a_module_path_config_loads(tmp_path):
    c = case("v1_frame_gate_residual_prenorm_leakyrelu")
    sd = {k: torch.from_numpy(np.array(v)) + 1.0 for k, v in state_dict_from_jax_params(c.jax_params).items()}
    sd["ddpm.gamma.gamma"] = torch.zeros(11)  # the reference schedule's buffer, not a parameter
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": sd, "epoch": 1}, path)
    fresh = EquivariantVariationalDiffusion(GCPNetDynamics(*c.cfgs), c.cfgs[3], c.cfgs[4])
    load_reference_checkpoint(fresh, str(path))
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd["ddpm." + k].numpy(), err_msg=k)
    assert any(".gcp_norm.0.scalar_norm.weight" in k for k in sd)


# -- port only -------------------------------------------------------------------------------


def test_shipped_config_module_forward_equals_packed():
    """The shipped configuration takes the packed forward; with fast="off" the
    module forward, which gives the same output and gradients."""
    cfgs = tiny_configs()
    packed, module = GCPNetDynamics(*cfgs), GCPNetDynamics(*cfgs, fast="off")
    assert packed.packed and not module.packed
    init_random_weights(packed, 4)
    module.load_state_dict(packed.state_dict())
    xh, t, mask = (torch.from_numpy(a) for a in tiny_batch(seed=2))
    w = torch.from_numpy(np.random.default_rng(2).normal(size=xh.shape).astype(np.float32))
    outs, grads = [], []
    for dyn in (packed, module):
        out = dyn(xh, t, mask)
        grads.append(torch.autograd.grad((out * w).sum(), list(dyn.parameters())))
        outs.append(out.detach())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=ATOL)
    scale = max(g.abs().max().item() for g in grads[0])
    for (name, _), a, b in zip(packed.named_parameters(), *grads):
        torch.testing.assert_close(b, a, rtol=0, atol=GRAD_REL * scale, msg=name)


@pytest.mark.parametrize("vector_gate", [True, False])
def test_fused_first_message_equals_plain_gcp2(vector_gate):
    """``GCP2FusedEdgeMessage`` against a plain GCP2 on the materialized
    ``[s_i | e_ij | s_j]``, ``[v_i | xi_ij | v_j]`` with the same weights."""
    from bio_diffusion_torch.models.gcp import GCP2
    from bio_diffusion_torch.models.gcp_fused import GCP2FusedEdgeMessage

    s_dim, v_dim, se, ve, b, n = 16, 4, 8, 2, 2, 5
    fused = GCP2FusedEdgeMessage((s_dim, v_dim), (se, ve), (s_dim, v_dim), vector_gate=vector_gate, bottleneck=4)
    plain = GCP2((2 * s_dim + se, 2 * v_dim + ve), (s_dim, v_dim), bottleneck=4, vector_gate=vector_gate)
    init_random_weights(fused, 3)
    plain.load_state_dict(fused.state_dict())  # strict: the same names and shapes
    gen = torch.Generator().manual_seed(0)
    s, v = torch.randn(b, n, s_dim, generator=gen), torch.randn(b, n, 3, v_dim, generator=gen)
    e, xi = torch.randn(b, n, n, se, generator=gen), torch.randn(b, n, n, 3, ve, generator=gen)
    frames = torch.randn(b, n, n, 3, 3, generator=gen)
    s_i, v_i = s[:, :, None].expand(b, n, n, s_dim), v[:, :, None].expand(b, n, n, 3, v_dim)
    ref = plain(torch.cat([s_i, e, s_i.transpose(1, 2)], -1), torch.cat([v_i, xi, v_i.transpose(1, 2)], -1),
                frames)
    got = fused(s, v, e, xi, frames)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5)


def test_path_is_chosen_by_configuration():
    mc, mod, lc, dc, dl = tiny_configs()
    assert GCPNetDynamics(mc, mod, lc, dc, dl).packed
    for fast in ("auto", "on", "pallas"):
        assert GCPNetDynamics(mc, mod, lc, dc, dl, fast=fast).packed
    other = dataclasses.replace(mod, frame_gate=True)
    assert not supports_fast_path(other, lc)
    assert not GCPNetDynamics(mc, other, lc, dc, dl).packed
    for fast in ("on", "pallas"):
        with pytest.raises(ValueError, match="not supported by the fast path"):
            GCPNetDynamics(mc, other, lc, dc, dl, fast=fast)


def test_configurations_jax_cannot_build_raise_in_both():
    mc, mod, lc, dc, dl = jax_tiny_configs()
    xh, t, mask = (jnp.asarray(a) for a in tiny_batch())
    bad = dataclasses.replace(mod, default_vector_residual=True)
    with pytest.raises(TypeError):  # the first message GCP adds 2V+Ve channels to V
        jax.eval_shape(lambda: JaxDynamics(mc, bad, lc, dc, dl).init(jax.random.PRNGKey(0), xh, t, mask))
    pc = tiny_configs()
    with pytest.raises(ValueError, match="vector_residual"):
        GCPNetDynamics(pc[0], dataclasses.replace(pc[1], default_vector_residual=True), *pc[2:])
    odd = dataclasses.replace(pc[1], scalar_nonlinearity="gelu")
    with pytest.raises(NotImplementedError, match="gelu"):
        GCPNetDynamics(pc[0], odd, *pc[2:])


def test_scalar_vector_matches_jax():
    """``ScalarVector``'s concat, mask, add and flatten/recover against the JAX package's."""
    from bio_diffusion_torch.ops.scalar_vector import ScalarVector
    from bio_diffusion_tpu.ops.scalar_vector import ScalarVector as JaxSV

    rng = np.random.default_rng(0)
    a, b = ((rng.normal(size=(2, 5, 3)).astype(np.float32), rng.normal(size=(2, 5, 4, 3)).astype(np.float32))
            for _ in range(2))
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    ours = ScalarVector(*map(torch.from_numpy, a)).concat(ScalarVector(*map(torch.from_numpy, b)))
    ref = JaxSV(*map(jnp.asarray, a)).concat(JaxSV(*map(jnp.asarray, b)))
    for got, want in ((ours, ref), (ours.mask(torch.from_numpy(mask)), ref.mask(jnp.asarray(mask))),
                      (ours + ours, ref + ref), (ScalarVector.recover(ours.flatten(), 8), JaxSV.recover(ref.flatten(), 8))):
        np.testing.assert_array_equal(got.scalar.numpy(), np.asarray(want.scalar))
        np.testing.assert_array_equal(got.vector.numpy(), np.asarray(want.vector))
    np.testing.assert_array_equal(ours.flatten().numpy(), np.asarray(ref.flatten()))
    assert torch.equal(ScalarVector.from_cm(ours.scalar, ours.vector_cm).vector, ours.vector)
