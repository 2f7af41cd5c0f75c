"""Port parity: the learned noise schedule (``GammaNetwork``), alone and with
self-conditioning, against the JAX package.

The tiny QM9 model of ``test_torch_common`` (T=10) with
``noise_schedule=learned`` and ``loss_type=vlb``, with and without
``self_condition``, and the self-conditioned property-conditioned variant
for ``mol_gen_optimize``; weights drawn by the port and carried into JAX by
the JAX package's reference-name import, JAX's draws rebuilt from its key
splits (``test_torch_self_condition.py``'s builders).  Float32, CPU.

* ``GammaNetwork`` against the JAX module on the grid k/T and off it,
  within its float32 conditioning (``gamma_tol``, ~1e-3 at the
  initialization); monotone; the parameter gradients in float64 (the
  inner weights' float32 gradients are rounding-bound in both frameworks)
  rtol 1e-6, the endpoints' also in float32, rtol 2e-3.
* The frozen table (no gradients: sampling, serving) against the table
  JAX's ``build_fast_evd`` bakes, and its linear interpolation off the
  grid, within the same tolerance; rebuilt after an in-place parameter
  update.
* VLB ``loss_terms`` (training, evaluation; with self-conditioning the pass
  taken and not) at rtol 2e-3 and the full loss at rtol 2e-4 (gamma's
  conditioning carried by the SNR weight); the gradients at
  ``test_torch_train_step.py``'s tolerance or 1e-4 of the parameter's
  largest, the endpoints' included (the inner weights' are only finite:
  rounding-bound in float32, held in float64 above); three AMSGrad steps,
  whose schedule endpoints move from -5 and 10, at the tolerances of
  ``test_torch_train_step.py``.
* The sampler against JAX's ``SegmentedSampler`` on the grid and at 4
  steps of T=10 (off the grid), ``inpaint`` and ``mol_gen_optimize`` with
  both options, against JAX's sampling EVD (``build_fast_evd``) reading the
  port's table: ``test_torch_self_condition.py``'s tolerances.
* A JAX self-conditioned, learned-schedule model exported by
  ``export_state_dict`` loads with ``strict=True``; ``cli.train`` with both
  options trains, logs no log-SNR endpoints, checkpoints and warm-starts
  the schedule's five tensors with the rest, and ``cli.mol_gen_sample``
  samples from its checkpoint.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.models.diffusion import GammaNetwork as JaxGammaNetwork
from bio_diffusion_torch.models.diffusion import GammaNetwork
from test_torch_common import TINY_OVERRIDES
from test_torch_self_condition import (
    Models,
    check_inpaint,
    check_loss_gradients,
    check_loss_terms,
    check_optimize,
    check_three_steps,
    learned_only,
    loss_cases,
    mixed_key,
    self_conditioned,
)

GAMMA_NAMES = ("gamma.l1.weight", "gamma.l1.bias", "gamma.l2.weight", "gamma.l2.bias", "gamma.l3.weight",
               "gamma.l3.bias", "gamma.gamma_0", "gamma.gamma_1")
SC_LEARNED = ["model.diffusion_cfg.self_condition=true", "model.diffusion_cfg.noise_schedule=learned",
              "model.diffusion_cfg.loss_type=vlb"]

# the network path of the learned schedule (loss terms, gradients) in both
# frameworks: gamma itself agrees only within gamma_tol (~1e-3 at the
# initialization, float32 cancellation in the reference's design, the JAX
# module's error against float64 alike), and the SNR weight exp(gamma_t -
# gamma_s) - 1 and the VLB loss carry it: 2.6e-4 relative at most seen
TOL_TERMS_LEARNED = dict(rtol=2e-3, atol=2e-4)
LOSS_RTOL_LEARNED = 2e-4
# and every gradient (the weight is a factor of it), relative to the largest
# of its parameter where rows' contributions cancel (3e-5 seen); the
# schedule's inner weights are rounding-bound in float32 (held in float64 by
# test_gamma_network_matches_jax)
GRAD_ATOL_OF_MAX_LEARNED = 1e-4
INNER_GAMMA = ("gamma.l1.weight", "gamma.l1.bias", "gamma.l2.weight", "gamma.l2.bias", "gamma.l3.weight",
               "gamma.l3.bias")

_MODELS = {}


def models(name):
    """Built once a module: ``learned``, ``sc_learned``, ``sc_cond_learned``."""
    if name not in _MODELS:
        configure = {"learned": learned_only,
                     "sc_learned": lambda c: self_conditioned(c, learned=True),
                     "sc_cond_learned": lambda c: self_conditioned(c, conditional=True, learned=True)}[name]
        _MODELS[name] = Models(configure, seed=7)
    return _MODELS[name]


def jax_gamma_params(net):
    """The port ``GammaNetwork``'s weights as the JAX module's params
    (``PositiveLinear`` weights ``[in, out]``)."""
    tree = {}
    for name in ("l1", "l2", "l3"):
        layer = getattr(net, name)
        tree[name] = {"weight": jnp.asarray(layer.weight.detach().numpy().T),
                      "bias": jnp.asarray(layer.bias.detach().numpy())}
    tree["gamma_0"] = jnp.asarray(net.gamma_0.detach().numpy())
    tree["gamma_1"] = jnp.asarray(net.gamma_1.detach().numpy())
    return {"params": tree}


def gamma_tol(net):
    """The float32 error of ``GammaNetwork`` (8 roundings): its output
    rescales gamma_tilde(t) - gamma_tilde(0), a difference of two values
    ~70 whose spread gamma_tilde(1) - gamma_tilde(0) is ~0.7 at the
    initialization, so a rounding of gamma_tilde is amplified by
    max|gamma_tilde| / spread * |gamma_1 - gamma_0| (~1e-4 here; the JAX
    module carries the same error against float64)."""
    with torch.no_grad():
        g0, g1 = net.gamma_tilde(torch.zeros(1, 1)).item(), net.gamma_tilde(torch.ones(1, 1)).item()
        span = abs(net.gamma_1.item() - net.gamma_0.item())
    return 8 * np.finfo(np.float32).eps * max(abs(g0), abs(g1)) / abs(g1 - g0) * span


def jax_frozen(m):
    """JAX's sampling EVD (``build_fast_evd``: the baked denoiser and a
    frozen schedule) reading the port's table, so that both sample from the
    same gamma values; the tables themselves agree within ``gamma_tol``
    (``test_frozen_table_matches_build_fast_evd``)."""
    from bio_diffusion_tpu.train.sampling import build_fast_evd

    return build_fast_evd(m.evd_j, m.params).clone(gamma_table_override=jnp.asarray(m.evd.gamma.table().numpy()))


def test_gamma_network_matches_jax():
    net = GammaNetwork(10)
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # endpoints away from their initial values
        net.gamma_0.add_(0.3)
        net.gamma_1.sub_(0.7)
    params = jax_gamma_params(net)
    jnet = JaxGammaNetwork()
    t = np.concatenate([np.arange(11, dtype=np.float32) / 10,
                        np.random.default_rng(0).uniform(size=7).astype(np.float32)])[:, None]
    ref = np.asarray(jnet.apply(params, jnp.asarray(t)))
    out = net(torch.from_numpy(t))
    tol = gamma_tol(net)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=tol)
    np.testing.assert_allclose(out.detach().numpy()[[0, 10], 0], [-4.7, 9.3], rtol=0, atol=tol)
    # monotone in t
    fine = torch.linspace(0, 1, 1001)[:, None]
    assert bool((torch.diff(net(fine).detach()[:, 0]) > 0).all())
    # gradients of a weighted sum, every parameter: the endpoints' in
    # float32 (their normalized t carries the cancellation, 1.7e-4 relative
    # seen); all of them in float64 (jax.enable_x64), where the inner
    # weights' float32 gradients are rounding-bound (~10-20% off float64 in
    # either framework at this initialization)
    w = np.random.default_rng(1).normal(size=t.shape).astype(np.float32)

    def jax_grads(params, tt, ww):
        g = jax.grad(lambda p: jnp.sum(jnet.apply(p, tt) * ww))(params)["params"]
        return {n: np.asarray(g[n] if "." not in n else g[n.split(".")[0]][n.split(".")[1]]) for n, _ in
                net.named_parameters()}

    ref32 = jax_grads(params, jnp.asarray(t), jnp.asarray(w))
    grads = torch.autograd.grad((net(torch.from_numpy(t)) * torch.from_numpy(w)).sum(), list(net.parameters()))
    for (name, _), g in zip(net.named_parameters(), grads):
        if name.startswith("gamma_"):
            np.testing.assert_allclose(g.numpy(), ref32[name], rtol=2e-3, atol=1e-7, err_msg=name)
    net64 = GammaNetwork(10).double()
    net64.load_state_dict({k: v.double() for k, v in net.state_dict().items()})
    grads64 = torch.autograd.grad((net64(torch.from_numpy(t).double()) * torch.from_numpy(w).double()).sum(),
                                  list(net64.parameters()))
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        ref64 = jax_grads(p64, jnp.asarray(t.astype(np.float64)), jnp.asarray(w.astype(np.float64)))
        np.testing.assert_allclose(net64(torch.from_numpy(t).double()).detach().numpy(),
                                   np.asarray(jnet.apply(p64, jnp.asarray(t.astype(np.float64)))), rtol=1e-12)
    for (name, _), g in zip(net64.named_parameters(), grads64):
        ref_g = ref64[name].T if name.endswith("weight") else ref64[name]
        assert ref_g.dtype == np.float64
        if name == "l3.bias":  # the normalization cancels l3's bias: its gradient is 0 to rounding
            assert abs(g.item()) < 1e-10 and abs(ref_g.item()) < 1e-10
            continue
        assert g.abs().max() > 0, name
        # float64 cancels as float32 does, 1e8 times smaller (1e-7 relative seen)
        np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-6, atol=1e-6 * np.abs(ref_g).max(), err_msg=name)


def test_frozen_table_matches_build_fast_evd():
    from bio_diffusion_tpu.train.sampling import build_fast_evd

    m = models("learned")
    fast = build_fast_evd(m.evd_j, m.params)
    gamma = m.evd.gamma
    table = gamma.table()
    tol = gamma_tol(gamma)
    np.testing.assert_allclose(table.numpy(), np.asarray(fast.gamma_table_override), rtol=0, atol=tol)
    t = np.array([[0.0], [0.05], [0.125], [0.3], [0.37], [0.999], [1.0]], np.float32)
    ref = np.asarray(fast.apply({}, jnp.asarray(t), method=fast.gamma))
    with torch.no_grad(), m.evd.frozen_schedule():
        frozen = gamma(torch.from_numpy(t))
        # off the grid: linear between the table's neighbours
        np.testing.assert_allclose(frozen.numpy()[1, 0], 0.5 * (table[0] + table[1]).item(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(frozen.numpy(), ref, rtol=0, atol=tol)
    # outside the sampling loops the network runs; on the grid the two agree
    assert not gamma.frozen
    np.testing.assert_allclose(gamma(torch.from_numpy(t[[0, 3, 6]])).detach().numpy(), frozen.numpy()[[0, 3, 6]],
                               rtol=0, atol=tol)
    # the interpolated table on the same table as the JAX fast EVD's
    same = fast.clone(gamma_table_override=jnp.asarray(table.numpy()))
    np.testing.assert_allclose(frozen.numpy(), np.asarray(same.apply({}, jnp.asarray(t), method=same.gamma)),
                               rtol=0, atol=1e-6)
    # an in-place update (an optimizer or EMA step) rebuilds the table
    with torch.no_grad():
        gamma.gamma_1.add_(1.0)
        assert gamma.table()[-1].item() == pytest.approx(table[-1].item() + 1.0, abs=1e-5)
        gamma.gamma_1.sub_(1.0)
    np.testing.assert_allclose(gamma.table().numpy(), table.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("training", [True, False])
def test_learned_loss_terms_match_jax(training):
    check_loss_terms(models("learned"), jax.random.PRNGKey(7), training, TOL_TERMS_LEARNED)


@pytest.mark.parametrize("case", ["taken", "not_taken"])
def test_self_conditioned_learned_loss_terms_match_jax(case):
    m = models("sc_learned")
    rng = loss_cases(m)[case]
    assert m.sc_runs(rng) == (case == "taken")
    check_loss_terms(m, rng, True, TOL_TERMS_LEARNED)


@pytest.mark.parametrize("name", ["learned", "sc_learned"])
def test_learned_loss_gradients_match_jax(name):
    m = models(name)
    rng = loss_cases(m)["taken"] if name == "sc_learned" else jax.random.PRNGKey(3)
    check_loss_gradients(m, rng, LOSS_RTOL_LEARNED, atol_of_max=GRAD_ATOL_OF_MAX_LEARNED,
                         rounding_bound=INNER_GAMMA)


@pytest.mark.parametrize("name", ["learned", "sc_learned"])
def test_learned_train_steps_match_jax(name):
    """Three AMSGrad steps; the schedule's endpoints moved from -5 and 10 by
    at least one learning rate, in the port as in JAX (held by
    ``check_three_steps``)."""
    m = models(name)
    key = mixed_key(m) if name == "sc_learned" else jax.random.PRNGKey(11)
    params = check_three_steps(m, key)
    lr = 1e-4  # OptimizerConfig().lr
    assert abs(params["gamma.gamma_0"].item() + 5.0) > lr
    assert abs(params["gamma.gamma_1"].item() - 10.0) > lr


@pytest.mark.parametrize("name, num_timesteps", [("learned", 4), ("sc_learned", None)])
def test_learned_sampler_matches_jax(name, num_timesteps):
    """The port's sampler against JAX's ``SegmentedSampler`` on the fast
    EVD (``jax_frozen``); 4 steps of T=10 query the table between grid
    points."""
    from bio_diffusion_tpu.train.sampling import SegmentedSampler as JaxSampler
    from bio_diffusion_torch.train.sampling import SegmentedSampler
    from test_torch_self_condition import assert_decoded_close

    m = models(name)
    mask = m.batch.node_mask
    T_s = m.T if num_timesteps is None else num_timesteps
    key = jax.random.PRNGKey(23)
    xh_j = JaxSampler(jax_frozen(m), {}, fast="off").run(key, jnp.asarray(mask), num_timesteps=num_timesteps)
    per = m.evd.draws_per_step
    key, k_init = jax.random.split(key)
    key, k_seg = jax.random.split(key)
    draws, carry = [m.raw_noise(k_init)], k_seg
    for _ in range(T_s):
        carry, k1, k2 = jax.random.split(carry, 3)
        draws += [m.raw_noise(k1), m.raw_noise(k2)][:per]
    _, k_dec = jax.random.split(key)
    draws.append(m.raw_noise(k_dec))
    xh = SegmentedSampler(m.evd, "cpu").run(mask, None, num_timesteps, noises=draws)
    assert xh.shape == xh_j.shape and np.isfinite(xh).all()
    assert_decoded_close(xh, xh_j, m)


def test_self_conditioned_learned_inpaint_matches_jax():
    m = models("sc_learned")
    check_inpaint(m, jax_evd=jax_frozen(m), jax_params={})


def test_self_conditioned_learned_mol_gen_optimize_matches_jax():
    m = models("sc_cond_learned")
    check_optimize(m, jax_evd=jax_frozen(m), jax_params={})


def test_jax_export_loads_strictly():
    """A JAX self-conditioned, learned-schedule model exported to the
    reference's names loads into the port with ``strict=True``: the
    schedule at ``ddpm.gamma.l{1,2,3}.weight|bias`` and
    ``ddpm.gamma.gamma_0|gamma_1``, weights transposed to ``[out, in]``."""
    from bio_diffusion_tpu.train.torch_import import export_state_dict
    from bio_diffusion_torch.train.torch_import import load_reference_state_dict, state_dict_from_jax_params

    m = models("sc_learned")
    ref = export_state_dict(jax.device_get(m.params))
    ours = state_dict_from_jax_params(jax.device_get(m.params))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape and np.array_equal(ours[k], ref[k]), k
    assert {"ddpm." + k for k in GAMMA_NAMES} <= set(ref)
    assert ref["ddpm.gamma.l2.weight"].shape == (1024, 1) and ref["ddpm.gamma.l3.weight"].shape == (1, 1024)
    fresh = m.fresh_port_evd()
    load_reference_state_dict(fresh, ref)
    for k, v in m.evd.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # a predefined-schedule model refuses the schedule's tensors
    plain = Models(lambda c: self_conditioned(c), seed=7).evd
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference_state_dict(plain, ref)


def test_trainer_with_self_conditioning_and_learned_schedule(tmp_path):
    """``cli.train`` with both options at the tiny width: 2 steps with EMA
    validation (no log-SNR endpoints logged, as JAX skips them under a
    learned schedule), the schedule's tensors in the checkpoint's weights,
    EMA and AMSGrad moments, a warm start that loads every tensor, and
    ``cli.mol_gen_sample`` from the checkpoint."""
    from bio_diffusion_torch.cli import mol_gen_sample, train
    from bio_diffusion_torch.train import checkpoints as ck

    args = TINY_OVERRIDES + SC_LEARNED + ["datamodule.dataloader_cfg.batch_size=8",
                                          "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
                                          "trainer.check_val_every_n_epoch=1",
                                          "model.diffusion_cfg.sample_during_training=false", "--device=cpu"]
    trainer = train.main(args + ["--max-epochs=1", f"--workdir={tmp_path}/wd"])
    assert trainer.state.count == 2
    names = [n for n, _ in trainer.evd.named_parameters()]
    assert set(GAMMA_NAMES) <= set(names) and len(trainer.state.params) == len(names)
    assert len(trainer.state.ema_params) == len(names) == len(trainer.state.mu)
    rows = trainer.loggers.loggers[0].rows
    val = [r for r in rows if "valid/loss" in r]
    assert val and np.isfinite(val[-1]["valid/loss"]) and not any("valid/log_SNR_max" in r for r in rows)
    payload = ck.load_checkpoint(trainer.ckpt_dir)
    for key in ("state_dict", "ema_state_dict"):
        assert {"ddpm." + k for k in GAMMA_NAMES} <= set(payload[key])
    assert {"ddpm." + k for k in GAMMA_NAMES} <= set(payload["optimizer"]["mu"])
    gamma_0 = payload["state_dict"]["ddpm.gamma.gamma_0"].item()
    assert gamma_0 != -5.0 and gamma_0 == trainer.evd.gamma.gamma_0.item()
    merged, n_loaded, skipped = ck.warm_start_params(trainer.ckpt_dir, ck.reference_state_dict(trainer.evd))
    assert n_loaded == len(merged) and not skipped
    out = tmp_path / "samples"
    mol_gen_sample.main(TINY_OVERRIDES + SC_LEARNED + [f"ckpt_path={trainer.ckpt_dir}", "device=cpu",
                                                      "num_samples=2", f"output_dir={out}"])
    assert len([f for _, _, fs in os.walk(out) for f in fs if f.endswith(".xyz")]) == 2
