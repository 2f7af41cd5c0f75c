"""Port parity: the EGNN ablation denoiser, against the JAX package.

The tiny QM9 model of ``test_torch_common`` (H=16, E=8, 2 layers, T=10) with
``dynamics_network=egnn``: the weights are drawn by the port
(``init_random_weights``, the JAX initialization) and carried into JAX's
``EGNNDynamics`` through its strict reference-name import; the inputs come
from numpy (B=2, N=7, two padded rows).  CPU, float32.

* The denoiser's output, plain and self-conditioned with a property
  context: atol 1e-4; in bf16 within 1e-2 of max|output|.
* The gradients of ``sum(out * w)`` against ``jax.grad``, within 1e-4 of
  the largest gradient.  JAX's ``CoorsNorm`` takes the norm as ``sqrt`` of
  the squared norm, whose gradient at a self-loop's zero vector is NaN (0 x
  inf) and reaches every parameter upstream of a layer's positions; the
  port passes no gradient through a zero vector (its value is 0 in all
  three).  The JAX side of this comparison therefore runs with
  ``CoorsNorm`` doing the same (``_ZeroSafeCoorsNorm``, the same forward),
  and the test also holds that JAX's own gradients are non-finite where
  the port's are finite.
* The weight mapping equals ``export_state_dict`` and loads strictly.
* ``loss_terms`` through the EVD in training and evaluation with JAX's
  draws, and ``build_evd`` for ``dynamics_network=egnn`` (an unknown name
  raises ``ValueError``; ``fast_train=on`` raises).
* ``init_random_weights``: xavier-normal MLP weights (truncated at two
  deviations), zero MLP biases, torch-default embeddings, norms at ones and
  zeros, ``CoorsNorm.scale`` 1e-2.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from bio_diffusion_tpu.models import egnn as jax_egnn
from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
from bio_diffusion_tpu.train.torch_import import export_state_dict, import_state_dict
from bio_diffusion_torch.config.build import build_evd, build_experiment
from bio_diffusion_torch.config.loader import default_config_dir, load_config
from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
from bio_diffusion_torch.models.egnn import CoorsNorm, EGNNDynamics, GraphLayerNorm, XavierLinear
from bio_diffusion_torch.train.torch_import import (
    init_random_weights,
    load_reference_state_dict,
    state_dict_from_jax_params,
)
from test_torch_common import TINY_OVERRIDES, jax_tiny_configs, tiny_batch, tiny_configs

ATOL = 1e-4
GRAD_REL = 1e-4
TOL_TERMS = dict(rtol=2e-4, atol=2e-4)  # as tests/test_torch_train_step.py


class _ZeroSafeCoorsNorm(jax_egnn.CoorsNorm):
    """JAX's CoorsNorm passing no gradient through a zero vector, as the
    port's: the same value."""

    @fnn.compact
    def __call__(self, coors):
        scale = self.param("scale", lambda k, s: jnp.full(s, self.scale_init), (1,))
        sq = jnp.sum(coors * coors, axis=-1, keepdims=True)
        pos = sq > 0
        norm = jnp.sqrt(jnp.where(pos, sq, 1.0))
        return jnp.where(pos, coors / jnp.maximum(norm, self.eps), 0.0) * scale


def egnn_configs(cfgs, self_condition=False, context=False):
    mc, mod, lc, dc, dl = cfgs
    dc = dataclasses.replace(dc, dynamics_network="egnn", self_condition=self_condition)
    if context:
        mod = dataclasses.replace(mod, conditioning=("alpha",))
    return mc, mod, lc, dc, dl


class Case:
    """The port's EGNN and JAX's with the same weights, the numpy inputs,
    and both sides' outputs and gradients."""

    def __init__(self, seed, self_condition=False, context=False, precision=None, grads=True):
        self.cfgs = egnn_configs(tiny_configs(), self_condition, context)
        jcfgs = egnn_configs(jax_tiny_configs(), self_condition, context)
        self.evd = EquivariantVariationalDiffusion(EGNNDynamics(*self.cfgs, compute_dtype=precision),
                                                   self.cfgs[3], self.cfgs[4])
        init_random_weights(self.evd, seed)
        xh, t, mask = tiny_batch(seed=seed)
        rng = np.random.default_rng(seed)
        kw = {}
        if self_condition:
            kw["xh_self_cond"] = (rng.normal(size=xh.shape) * mask[..., None]).astype(np.float32)
        if context:
            kw["context"] = (rng.normal(size=(2, 1, 1)) * mask[..., None]).astype(np.float32)
        w = rng.normal(size=xh.shape).astype(np.float32)
        net = jax_egnn.EGNNDynamics(*jcfgs, compute_dtype=precision)
        j_in = [jnp.asarray(a) for a in (xh, t, mask)]
        j_kw = {k: jnp.asarray(v) for k, v in kw.items()}
        shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), *j_in, **j_kw))
        template = {"params": {"dynamics": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])}}
        self.jax_params = import_state_dict({"ddpm." + k: v.numpy() for k, v in self.evd.state_dict().items()},
                                            template)
        p = jax.tree.map(jnp.asarray, self.jax_params["params"]["dynamics"])

        def loss(params):
            out = net.apply({"params": params}, *j_in, **j_kw)
            return jnp.sum(out.astype(jnp.float32) * w), out

        prefix = "ddpm.dynamics_network."

        def named(tree):
            return {k[len(prefix):]: v for k, v in export_state_dict({"params": {"dynamics": tree}}).items()}

        if grads:
            self.jax_grads_own = named(jax.device_get(jax.jit(jax.grad(lambda q: loss(q)[0]))(p)))
            orig = jax_egnn.CoorsNorm
            jax_egnn.CoorsNorm = _ZeroSafeCoorsNorm  # looked up when EGNNSparseLayer runs
            try:
                (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)
            finally:
                jax_egnn.CoorsNorm = orig
            self.jax_grads = named(jax.device_get(g))
        else:
            out = jax.jit(lambda q: loss(q)[1])(p)
        self.jax_out = np.asarray(out, np.float32)

        dyn = self.evd.dynamics_network
        out = dyn(*(torch.from_numpy(a) for a in (xh, t, mask)), **{k: torch.from_numpy(v) for k, v in kw.items()})
        self.out = out.detach().numpy()
        if grads:
            names = [k for k, _ in dyn.named_parameters()]
            g = torch.autograd.grad((out * torch.from_numpy(w)).sum(), list(dyn.parameters()))
            self.grads = {k: v.numpy() for k, v in zip(names, g)}


CASES = {"plain": dict(seed=1), "self_condition_context": dict(seed=2, self_condition=True, context=True)}
_BUILT = {}


def case(name):
    if name not in _BUILT:
        kw = {"bf16": dict(seed=3, precision="bfloat16", grads=False)}.get(name) or CASES[name]
        _BUILT[name] = Case(**kw)
    return _BUILT[name]


@pytest.mark.parametrize("name", list(CASES))
def test_egnn_forward_matches_jax(name):
    c = case(name)
    assert np.isfinite(c.out).all()
    np.testing.assert_allclose(c.out, c.jax_out, rtol=0, atol=ATOL)


def test_egnn_bf16_forward_matches_jax():
    c = case("bf16")
    assert np.isfinite(c.out).all()
    np.testing.assert_allclose(c.out, c.jax_out, rtol=0, atol=1e-2 * np.abs(c.jax_out).max())


@pytest.mark.parametrize("name", list(CASES))
def test_egnn_gradients_match_jax(name):
    c = case(name)
    assert sorted(c.grads) == sorted(c.jax_grads)
    scale = max(np.abs(g).max() for g in c.jax_grads.values())
    for k, g in c.grads.items():
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, c.jax_grads[k], rtol=0, atol=GRAD_REL * scale, err_msg=k)
    # JAX's own CoorsNorm: NaN gradients through the self-loops' zero norms
    assert not all(np.isfinite(g).all() for g in c.jax_grads_own.values())


@pytest.mark.parametrize("name", list(CASES))
def test_egnn_weight_mapping_matches_export(name):
    c = case(name)
    ours, ref = state_dict_from_jax_params(c.jax_params), export_state_dict(c.jax_params)
    assert sorted(ours) == sorted(ref)
    assert any(".egnn.mpnn_layers.1.coors_mlp.3.weight" in k for k in ours)
    for k in ref:
        assert ours[k].shape == ref[k].shape and np.array_equal(ours[k], ref[k]), k
    fresh = EquivariantVariationalDiffusion(EGNNDynamics(*c.cfgs), c.cfgs[3], c.cfgs[4])
    load_reference_state_dict(fresh, ours)  # strict
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), c.evd.state_dict()[k].numpy(), err_msg=k)


@pytest.mark.parametrize("training", [True, False])
def test_egnn_loss_terms_match_jax(training):
    """``loss_terms`` through the EVD with JAX's draws (``key_t, key_eps,
    key_sc, key_bern, key_eps0``)."""
    from bio_diffusion_tpu.models.egnn import EGNNDynamics as JaxEGNN

    c = case("plain")
    jcfgs = egnn_configs(jax_tiny_configs())
    evd_j = JaxEVD(dynamics=JaxEGNN(*jcfgs), diffusion_cfg=jcfgs[3], dataloader_cfg=jcfgs[4])
    xh, _, mask = tiny_batch(seed=5)
    rng = np.random.default_rng(5)
    h_cat = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=mask.shape)] * mask[..., None]
    h_int = rng.integers(1, 9, size=mask.shape + (1,)).astype(np.float32) * mask[..., None]
    x = xh[..., :3]
    key = jax.random.PRNGKey(7)
    params = {"params": {"dynamics": jax.tree.map(jnp.asarray, c.jax_params["params"]["dynamics"])}}
    ref = jax.jit(lambda p: evd_j.apply(p, *(jnp.asarray(a) for a in (x, h_cat, h_int, mask)), key,
                                        training=training, method=JaxEVD.loss_terms))(params)
    key_t, key_eps, _, _, key_eps0 = jax.random.split(key, 5)
    b, n = mask.shape

    def raw_noise(k):
        kx, kh = jax.random.split(k)
        return torch.from_numpy(np.concatenate([np.asarray(jax.random.normal(kx, (b, n, 3))),
                                                np.asarray(jax.random.normal(kh, (b, n, 6)))], -1))

    draws = {"t_int": torch.from_numpy(np.array(jax.random.randint(key_t, (b, 1), 0 if training else 1, 11),
                                                np.float32)), "eps_t": raw_noise(key_eps)}
    if not training:
        draws["eps_0"] = raw_noise(key_eps0)
    ours = c.evd.loss_terms(*(torch.from_numpy(a) for a in (x, h_cat, h_int, mask)), training, **draws)
    for k in ("error_t", "SNR_weight", "loss_0_x", "loss_0_h", "neg_log_constants", "kl_prior", "delta_log_px"):
        np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(ref[k]), **TOL_TERMS, err_msg=k)


def test_build_evd_selects_the_network():
    cfg = load_config(default_config_dir(), "train", ["experiment=qm9_mol_gen_ddpm", *TINY_OVERRIDES,
                                                      "model.diffusion_cfg.dynamics_network=egnn"])
    exp = build_experiment(cfg)
    evd = build_evd(exp)
    assert isinstance(evd.dynamics_network, EGNNDynamics) and not evd.dynamics_network.packed
    assert len(evd.dynamics_network.egnn.mpnn_layers) == exp.model_cfg.num_encoder_layers
    with pytest.raises(ValueError, match="fast path"):
        build_evd(exp, fast="on")
    exp.diffusion_cfg.dynamics_network = "transformer"
    with pytest.raises(ValueError, match="Unknown dynamics network transformer"):
        build_evd(exp)


def test_init_random_weights_gives_the_jax_initialization():
    cfgs = egnn_configs(tiny_configs())
    a, b = (EGNNDynamics(*cfgs) for _ in range(2))
    with torch.no_grad():
        for p in a.parameters():
            p.fill_(3.0)  # the norms and the scale are reset too
    init_random_weights(a, 4)
    init_random_weights(b, 4)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    mlp = [m for m in a.modules() if isinstance(m, XavierLinear)]
    assert len(mlp) == 6 * cfgs[0].num_encoder_layers
    w = torch.cat([m.weight.reshape(-1) for m in mlp if m.out_features > 1])
    big = mlp[0]  # edge_mlp.0: 41 -> 82
    std = math.sqrt(2.0 / (big.in_features + big.out_features))
    assert abs(big.weight.std().item() - std) < 0.1 * std
    assert big.weight.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert all(torch.all(m.bias == 0) for m in mlp) and torch.isfinite(w).all()
    for lin in (a.node_embedding, a.edge_embedding, a.scalar_node_projection):
        bound = 1.0 / math.sqrt(lin.in_features)
        assert lin.weight.abs().max().item() <= bound and lin.bias.abs().max().item() <= bound
        assert lin.bias.abs().max().item() > 0
    for m in a.modules():
        if isinstance(m, CoorsNorm):
            assert torch.equal(m.scale, torch.full((1,), 1e-2))
        if isinstance(m, GraphLayerNorm):
            assert torch.all(m.weight == 1) and torch.all(m.bias == 0)
