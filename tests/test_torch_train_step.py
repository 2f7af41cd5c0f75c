"""Port parity: the training step (loss terms, NLL, gradients, optimizer).

The port's ``EquivariantVariationalDiffusion.loss_terms`` and
``assemble_nll``, the full-loss gradients of its training forward, three
train steps and the learning-rate schedules are held against the JAX
package at the tiny width (S=16, V=4, Se=8, Ve=2, 2 layers, T=10), float32,
with the same weights and with JAX's own draws passed in (the timesteps and
the noise are rebuilt from the key splits of ``loss_terms``).  Tolerances
are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bio_diffusion_torch.config.schema import OptimizerConfig
from bio_diffusion_tpu.config.schema import OptimizerConfig as JaxOptimizerConfig
from bio_diffusion_tpu.data.batch import DenseMolBatch as JaxBatch
from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
from bio_diffusion_tpu.models.diffusion import assemble_nll as jax_assemble_nll
from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics
from bio_diffusion_tpu.models.gcpnet_fast import FastGCPNetDynamics
from bio_diffusion_tpu.ops.geometry import centralize as jax_centralize
from bio_diffusion_tpu.train import state as jax_state
from bio_diffusion_tpu.train.step import make_loss_fn as jax_make_loss_fn
from bio_diffusion_tpu.train.step import make_train_step as jax_make_train_step
from bio_diffusion_torch.data.batch import iterate_dense_batches
from bio_diffusion_torch.data.synthetic import synthetic_qm9_like
from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion, assemble_nll
from bio_diffusion_torch.models.distributions import NumNodesDistribution
from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
from bio_diffusion_torch.train.state import TrainState, make_lr_schedule
from bio_diffusion_torch.train.step import make_loss_fn, make_train_step
from bio_diffusion_torch.train.torch_import import load_reference_state_dict, state_dict_from_jax_params
from test_torch_common import jax_tiny_configs, tiny_configs

# loss terms and NLL: the denoiser agrees to ~1e-5 (test_torch_denoiser.py);
# the terms are sums of ~70 squared residuals
TOL_TERMS = dict(rtol=2e-4, atol=2e-4)
# gradients: the tolerance of tests/test_fast_train.py for Pallas-vs-module grads
TOL_GRAD = dict(rtol=2e-3, atol=2e-5)


@pytest.fixture(scope="module")
def setup():
    cfgs = tiny_configs()
    mc, mod, lc, dc, dl = jax_tiny_configs()
    ds = synthetic_qm9_like(num_molecules=6, max_nodes=7, seed=0)
    batch = next(iterate_dense_batches(ds, batch_size=6, shuffle=False, pad_to=7))
    batch_j = JaxBatch(*(jnp.asarray(a) for a in (batch.x, batch.one_hot, batch.charges, batch.node_mask)))
    net = JaxDynamics(mc, mod, lc, dc, dl, remat_interactions=False)
    evd_j = JaxEVD(dynamics=net, diffusion_cfg=dc, dataloader_cfg=dl)
    key = jax.random.PRNGKey(0)
    _, x0 = jax_centralize(batch_j.x, batch_j.node_mask)
    params = evd_j.init(key, x0, batch_j.one_hot, batch_j.charges, batch_j.node_mask, key, training=True)
    hist = {int(n): int(c) for n, c in zip(*np.unique(ds.data["num_atoms"], return_counts=True))}
    table = NumNodesDistribution(hist).log_prob_table
    return cfgs, batch, batch_j, evd_j, params, table


def port_evd(cfgs, params):
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    load_reference_state_dict(evd, state_dict_from_jax_params(params))
    return evd


def jax_draws(evd_j, params, rng, node_mask, training):
    """The draws ``loss_terms`` makes from ``rng`` (diffusion.py:400-402, 411, 481)."""
    key_t, key_eps, _, _, key_eps0 = jax.random.split(rng, 5)
    b = node_mask.shape[0]
    t_int = jax.random.randint(key_t, (b, 1), 0 if training else 1, evd_j.diffusion_cfg.num_timesteps + 1)
    noise = lambda k: evd_j.apply(params, k, node_mask, method=JaxEVD.sample_noise)  # noqa: E731
    draws = {"t_int": t_int.astype(jnp.float32), "eps_t": noise(key_eps)}
    if not training:
        draws["eps_0"] = noise(key_eps0)
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def torch_batch(batch):
    return batch.to("cpu")


@pytest.mark.parametrize("training", [True, False])
def test_loss_terms_and_nll_match_jax(setup, training):
    cfgs, batch, batch_j, evd_j, params, table = setup
    dc, dl = cfgs[3], cfgs[4]
    rng = jax.random.PRNGKey(7)
    _, x_j = jax_centralize(batch_j.x, batch_j.node_mask)
    ref = evd_j.apply(params, x_j, batch_j.one_hot, batch_j.charges, batch_j.node_mask, rng, training=training)
    draws = jax_draws(evd_j, params, rng, batch_j.node_mask, training)
    evd = port_evd(cfgs, params)
    b = torch_batch(batch)
    with torch.no_grad():
        terms = evd.loss_terms(torch.from_numpy(np.array(x_j)), b.one_hot, b.charges, b.node_mask,
                               training, **draws)
    assert set(terms) == set(ref)
    for k in ref:
        np.testing.assert_allclose(terms[k].numpy(), np.asarray(ref[k]), **TOL_TERMS, err_msg=k)
    log_pN = table[batch.node_mask.sum(-1).astype(np.int64)]
    kw = dict(loss_type=dc.loss_type, training=training, T=dc.num_timesteps, num_x_dims=3,
              num_node_scalar_features=6)
    nll_j, info_j = jax_assemble_nll(ref, log_pN=jnp.asarray(log_pN), **kw)
    nll, info = assemble_nll(terms, log_pN=torch.from_numpy(log_pN), **kw)
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j), **TOL_TERMS)
    assert set(info) == set(info_j)
    for k in info_j:
        np.testing.assert_allclose(info[k].numpy(), np.asarray(info_j[k]), **TOL_TERMS, err_msg=k)


def test_full_loss_gradients_match_jax_pallas_interpret(setup):
    """Gradients of the training loss with respect to every parameter: the
    port's training forward (live packed weights, the message layer's
    autograd Function) against jax.value_and_grad through
    FastGCPNetDynamics with the Pallas kernels in interpret mode."""
    cfgs, batch, batch_j, evd_j, params, table = setup
    mc, mod, lc, dc, dl = jax_tiny_configs()
    fast = FastGCPNetDynamics(mc, mod, lc, dc, dl, use_pallas=True, interpret=True)
    loss_j = jax_make_loss_fn(evd_j.clone(dynamics=fast), dc, dl, table, training=True)
    rng = jax.random.PRNGKey(3)
    (lj, _), g_j = jax.value_and_grad(loss_j, has_aux=True)(params, batch_j, rng)
    evd = port_evd(cfgs, params)
    loss_fn = make_loss_fn(evd, cfgs[3], cfgs[4], table, training=True)
    loss, _ = loss_fn(torch_batch(batch), None, jax_draws(evd_j, params, rng, batch_j.node_mask, True))
    names = [n for n, _ in evd.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in evd.named_parameters()])
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-5)
    ref = {k[len("ddpm."):]: v for k, v in state_dict_from_jax_params(jax.device_get(g_j)).items()}
    assert set(ref) == set(names)
    for name, g in zip(names, grads):
        assert g.abs().max() > 0, f"{name}: no gradient reached it"
        np.testing.assert_allclose(g.numpy(), ref[name], **TOL_GRAD, err_msg=name)


def test_three_train_steps_match_jax(setup):
    """Loss, grad norm and clip threshold per step, then the params, the EMA
    and the grad-norm history after three steps of the JAX train step
    (make_train_step over the packed forward) and the port's."""
    cfgs, batch, batch_j, evd_j, params, table = setup
    mc, mod, lc, dc, dl = jax_tiny_configs()
    opt_cfg = OptimizerConfig()
    fast = FastGCPNetDynamics(mc, mod, lc, dc, dl, use_pallas=False)
    optimizer = jax_state.make_optimizer(JaxOptimizerConfig())
    step_j = jax_make_train_step(evd_j.clone(dynamics=fast), optimizer, dc, dl, table, donate=False)
    state_j = jax_state.create_train_state(params, optimizer)

    evd = port_evd(cfgs, params)
    ema = port_evd(cfgs, params).requires_grad_(False)
    state = TrainState(list(evd.parameters()), list(ema.parameters()), opt_cfg)
    step = make_train_step(evd, cfgs[3], cfgs[4], table)
    key = jax.random.PRNGKey(11)
    b = torch_batch(batch)
    for s in range(3):
        draws = jax_draws(evd_j, params, jax.random.fold_in(key, s), batch_j.node_mask, True)
        state_j, m_j = step_j(state_j, batch_j, key)
        m = step(state, b, None, draws)
        for k in ("loss", "grad_norm", "max_grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(m_j[k]), rtol=1e-4, err_msg=f"step {s}: {k}")
    assert state.count == int(state_j.step) == 3
    np.testing.assert_allclose(state.gradnorm_buffer.numpy(), np.asarray(state_j.gradnorm_buffer), rtol=1e-4)
    assert state.gradnorm_count == int(state_j.gradnorm_count)
    # AMSGrad moves every element by about lr per step whatever the size of its
    # gradient, so an element whose gradient is near 0 can move +lr in one
    # framework and -lr in the other: params may differ by 2 lr per step
    tol = 2 * opt_cfg.lr * 3
    for tree, module in ((state_j.params, evd), (state_j.ema_params, ema)):
        ref = {k[len("ddpm."):]: v for k, v in state_dict_from_jax_params(jax.device_get(tree)).items()}
        diffs = []
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0, atol=tol, err_msg=name)
            diffs.append(np.abs(p.detach().numpy() - ref[name]).ravel())
        # and most elements agree far more closely than that
        assert np.median(np.concatenate(diffs)) <= 1e-3 * opt_cfg.lr


def test_amsgrad_takes_the_max_over_bias_corrected_moments():
    """Two steps whose gradients shrink: optax's AMSGrad keeps the first
    step's bias-corrected second moment, torch.optim.AdamW(amsgrad=True)
    does not; the port matches optax."""
    kw = dict(lr=1e-2, weight_decay=1e-3)
    cfg = OptimizerConfig(**kw)
    p0 = np.array([0.5, -1.0, 2.0], np.float32)
    grads = [np.array([1.0, -2.0, 0.5], np.float32), np.array([0.1, -0.05, 0.4], np.float32)]

    optimizer = jax_state.make_optimizer(JaxOptimizerConfig(**kw))
    p_j = jnp.asarray(p0)
    opt_state = optimizer.init(p_j)
    for g in grads:
        upd, opt_state = optimizer.update(jnp.asarray(g), opt_state, p_j)
        p_j = optax.apply_updates(p_j, upd)

    p = torch.tensor(p0)
    state = TrainState([p], [p.clone()], cfg)
    for g in grads:
        state.apply_gradients([torch.tensor(g)])
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=1e-6, atol=1e-8)

    p_torch = torch.nn.Parameter(torch.tensor(p0))
    adamw = torch.optim.AdamW([p_torch], lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
                              weight_decay=cfg.weight_decay, amsgrad=True)
    for g in grads:
        p_torch.grad = torch.tensor(g)
        adamw.step()
    assert np.abs(p_torch.detach().numpy() - np.asarray(p_j)).max() > 1e-4


@pytest.mark.parametrize("kw", [
    {},
    {"scheduler": "step", "step_size": 3, "gamma": 0.5},
    {"scheduler": "cosine", "step_size": 5},
    {"scheduler": "linear_warmup", "warmup_steps": 4},
    {"scheduler": "step", "step_size": 2, "gamma": 0.7, "warmup_steps": 3},
])
def test_lr_schedule_matches_jax(kw):
    ref = jax_state.make_lr_schedule(JaxOptimizerConfig(lr=3e-4, **kw))
    ours = make_lr_schedule(OptimizerConfig(lr=3e-4, **kw))
    for count in range(13):
        want = ref(count) if callable(ref) else ref
        got = ours(count) if callable(ours) else ours
        np.testing.assert_allclose(got, float(want), rtol=1e-6, err_msg=f"count {count}")


def test_accumulated_step_equals_the_big_batch_step(setup):
    """accumulate_grad_batches=2 over two halves of a batch (equal sizes, the
    halves' draws) applies the same update as one step on the whole batch:
    the per-graph mean loss of the whole is the mean of the halves'.
    float32, atol 1e-6 on parameters of magnitude <= ~1 (summation order)."""
    cfgs, batch, batch_j, evd_j, params, table = setup
    dc, dl = cfgs[3], cfgs[4]
    draws = jax_draws(evd_j, params, jax.random.PRNGKey(5), batch_j.node_mask, True)
    full = torch_batch(batch)
    halves = [type(full)(*(t[sl] for t in (full.x, full.one_hot, full.charges, full.node_mask)))
              for sl in (slice(0, 3), slice(3, 6))]
    half_draws = [{k: v[sl] for k, v in draws.items()} for sl in (slice(0, 3), slice(3, 6))]
    results = []
    for k, b, d in ((1, full, draws), (2, halves, half_draws)):
        evd = port_evd(cfgs, params)
        ema = port_evd(cfgs, params).requires_grad_(False)
        state = TrainState(list(evd.parameters()), list(ema.parameters()), OptimizerConfig())
        metrics = make_train_step(evd, dc, dl, table, accumulate_grad_batches=k)(state, b, None, d)
        results.append((metrics, [p.detach().clone() for p in evd.parameters()]))
    (m1, p1), (m2, p2) = results
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(), rtol=1e-6)
    np.testing.assert_allclose(m2["grad_norm"].item(), m1["grad_norm"].item(), rtol=1e-5)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)
