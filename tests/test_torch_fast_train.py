"""The module path in training: ``trainer.fast_train``, GCP dropout, and the
training CLI with module-path denoisers, on the CPU at a tiny width.

* ``fast_train=off`` trains (and validates) through the module forward and
  takes the same first step as ``auto`` (the packed forward) from the same
  weights and draws: loss and gradient norm within 1e-5 relative, the
  parameters within 1e-6 after it; its sampling evaluation runs a packed
  twin carrying the EMA weights.  ``on`` and ``pallas`` on a configuration
  the packed forward does not implement raise ``ValueError`` when the
  Trainer is built, as JAX's Trainer does.
* ``GCPDropout``: without draws (evaluation) it is the identity, as at rate
  0; in training it keeps each scalar with probability 1-p (within 5
  standard deviations on 200k draws) and each vector channel whole (its
  three coordinates kept or dropped together), survivors scaled by
  1/(1-p); the same generator seed gives the same output; a batch's rows of
  a global draw are the rows of that draw.  Through ``loss_terms`` the
  training loss of a dropout model moves with the generator and repeats
  with its seed, evaluation does not draw, and a dropout model in training
  without a generator raises.
* ``cli.train`` runs 2 steps of a module-path GCPNet (GCP v1, frame gate,
  GCP norm, dropout) and of the EGNN denoiser: finite losses, no kernel
  launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bio_diffusion_torch.config.build import build_experiment
from bio_diffusion_torch.config.loader import default_config_dir, load_config
from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
from bio_diffusion_torch.models.nn import DropoutDraws, GCPDropout
from bio_diffusion_torch.ops.scalar_vector import ScalarVector
from bio_diffusion_torch.train.loop import Trainer
from bio_diffusion_torch.train.torch_import import init_random_weights
from test_torch_common import TINY_OVERRIDES, tiny_batch, tiny_configs

TRAIN = ["experiment=qm9_mol_gen_ddpm"] + TINY_OVERRIDES + ["datamodule.dataloader_cfg.batch_size=8"]
MODULE_PATH = ["model.module_cfg.selected_gcp=gcp", "model.module_cfg.frame_gate=true",
               "model.layer_cfg.use_gcp_norm=true", "model.layer_cfg.use_gcp_dropout=true",
               "model.model_cfg.dropout=0.1"]


def trainer(tmp_path, *overrides):
    cfg = load_config(default_config_dir(), "train", TRAIN + list(overrides))
    return Trainer(build_experiment(cfg), str(tmp_path), "cpu")


def first_step(tr):
    tr.init_state(resume=False)
    batch = next(iter(tr._train_batches())).to("cpu")
    metrics = tr.train_step(tr.state, batch, tr.step_generator())
    return {k: float(v) for k, v in metrics.items()}, [p.detach().clone() for p in tr.evd.parameters()]


def test_fast_train_off_takes_the_module_path_with_auto_s_step(tmp_path, monkeypatch):
    auto = trainer(tmp_path / "auto")
    off = trainer(tmp_path / "off", "trainer.fast_train=off")
    assert auto.evd.dynamics_network.packed and not off.evd.dynamics_network.packed
    bodies = []
    orig = GCPNetDynamics._module_body
    monkeypatch.setattr(GCPNetDynamics, "_module_body", lambda *a: bodies.append(1) or orig(*a))
    m_auto, p_auto = first_step(auto)
    assert not bodies
    m_off, p_off = first_step(off)
    assert bodies
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(m_off[k], m_auto[k], rtol=1e-5, err_msg=k)
    for a, b in zip(p_off, p_auto):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    # validation runs the EMA twin on the training path; sampling a packed twin
    assert not off.evd_ema.dynamics_network.packed
    twin = off._sampling_evd()
    assert twin is not off.evd_ema and twin.dynamics_network.packed
    for (k, a), b in zip(twin.state_dict().items(), off.evd_ema.state_dict().values()):
        assert torch.equal(a, b), k
    assert auto._sampling_evd() is auto.evd_ema


@pytest.mark.parametrize("fast", ["on", "pallas"])
def test_fast_train_on_an_unsupported_config_raises(tmp_path, fast):
    with pytest.raises(ValueError, match=f"fast_train={fast}"):
        trainer(tmp_path, f"trainer.fast_train={fast}", "model.module_cfg.frame_gate=true")
    assert trainer(tmp_path, f"trainer.fast_train={fast}").evd.dynamics_network.packed


# -- GCP dropout -------------------------------------------------------------------------------


def rep(seed=0, b=64, n=29, s=64, v=16):
    gen = torch.Generator().manual_seed(seed)
    return ScalarVector(torch.randn(b, n, s, generator=gen) + 3.0, torch.randn(b, n, v, 3, generator=gen) + 3.0)


def draws(seed):
    return DropoutDraws(torch.Generator().manual_seed(seed))


def test_gcp_dropout_without_draws_is_rate_zero():
    x = rep()
    for out in (GCPDropout(0.1)(x), GCPDropout(0.0)(x, draws(0)), GCPDropout(0.1, use_gcp_dropout=False)(x, draws(0))):
        assert torch.equal(out.scalar, x.scalar) and torch.equal(out.vector, x.vector)


def test_gcp_dropout_in_training():
    p = 0.1
    x = rep()
    out = GCPDropout(p)(x, draws(3))
    kept_s = out.scalar != 0
    n = kept_s.numel()
    assert abs(kept_s.float().mean().item() - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    torch.testing.assert_close(out.scalar[kept_s], x.scalar[kept_s] / (1 - p))
    kept_v = out.vector != 0  # [B, N, V, 3]
    assert torch.equal(kept_v.all(-1), kept_v.any(-1))  # whole channels
    channels = kept_v.all(-1)
    assert abs(channels.float().mean().item() - (1 - p)) < 5 * np.sqrt(p * (1 - p) / channels.numel())
    torch.testing.assert_close(out.vector[kept_v], x.vector[kept_v] / (1 - p))
    again = GCPDropout(p)(x, draws(3))
    assert torch.equal(again.scalar, out.scalar) and torch.equal(again.vector, out.vector)
    other = GCPDropout(p)(x, draws(4))
    assert not torch.equal(other.scalar, out.scalar)


def test_dropout_rows_are_rows_of_the_global_draw():
    whole = draws(5).keep((6, 7, 16), 0.1, "cpu")
    for rows in (slice(0, 3), slice(3, 6)):
        torch.testing.assert_close(DropoutDraws(torch.Generator().manual_seed(5), 6, rows).keep((3, 7, 16), 0.1, "cpu"),
                                   whole[rows])


def test_loss_terms_draw_dropout_in_training_only():
    mc, mod, lc, dc, dl = tiny_configs()
    cfgs = (dataclasses.replace(mc, dropout=0.1), mod, dataclasses.replace(lc, use_gcp_dropout=True), dc, dl)
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), dc, dl)
    assert not evd.dynamics_network.packed
    init_random_weights(evd, 0)
    xh, _, mask = (torch.from_numpy(a) for a in tiny_batch())
    rng = np.random.default_rng(0)
    h_cat = torch.from_numpy(np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=mask.shape)]) * mask[..., None]
    h_int = torch.ones(mask.shape + (1,)) * mask[..., None]
    args = (xh[..., :3], h_cat, h_int, mask)
    fixed = evd.loss_draws(mask, torch.Generator().manual_seed(1), training=True)

    def error(training, gen):
        return evd.loss_terms(*args, training, generator=gen, **fixed)["error_t"]

    a, b = error(True, torch.Generator().manual_seed(2)), error(True, torch.Generator().manual_seed(2))
    c = error(True, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    evd_fixed = dict(fixed, eps_0=fixed["eps_t"], t_int=fixed["t_int"].clamp(min=1))
    e1 = evd.loss_terms(*args, False, generator=None, **evd_fixed)["error_t"]
    e2 = evd.loss_terms(*args, False, generator=torch.Generator().manual_seed(9), **evd_fixed)["error_t"]
    assert torch.equal(e1, e2)
    with pytest.raises(ValueError, match="generator"):
        error(True, None)


# -- the training CLI --------------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [MODULE_PATH, ["model.diffusion_cfg.dynamics_network=egnn"]],
                         ids=["gcpnet_module_path", "egnn"])
def test_cli_train_runs_module_path_denoisers(tmp_path, overrides):
    from bio_diffusion_torch.cli.train import main
    from bio_diffusion_torch.ops import message_layer as ml

    before = dict(ml.launch_counts)
    tr = main(TRAIN + overrides + ["datamodule.dataloader_cfg.dataset=synthetic", "--device=cpu", "--max-steps=2",
                                   f"--workdir={tmp_path}"])
    assert ml.launch_counts == before
    assert tr.state.count == 2 and not tr.evd.dynamics_network.packed
    losses = [r["train/loss"] for r in tr.loggers.loggers[0].rows if "train/loss" in r]
    assert losses and np.all(np.isfinite(losses))
