"""The port's training path on the CPU at a tiny width, and its repairs.

* The synthetic QM9-schema data and its dense batches are identical to the
  JAX package's for the same seed.
* ``bio_diffusion_torch.cli.train.main`` trains two steps on the CPU, logs a
  finite loss and validates on the EMA weights; ``--device=cuda`` without a
  card raises (no fallback).
* Importing the port's training modules loads neither jax, flax or optax
  nor anything of the JAX package.
* The serving forward's packed weights follow in-place parameter updates
  (an optimizer step, an EMA update).
* The kernel build's digest covers the headers a source includes.
"""

import copy
import csv
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bio_diffusion_tpu.data.batch import iterate_dense_batches as jax_iterate
from bio_diffusion_tpu.data.synthetic import synthetic_qm9_like as jax_synthetic
from bio_diffusion_torch.data.batch import iterate_dense_batches
from bio_diffusion_torch.data.synthetic import synthetic_qm9_like
from test_torch_common import TINY_OVERRIDES, tiny_batch, tiny_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["experiment=qm9_mol_gen_ddpm"] + TINY_OVERRIDES + [
    "datamodule.dataloader_cfg.batch_size=32", "trainer.check_val_every_n_epoch=1"]


@pytest.mark.parametrize("num,max_nodes,seed", [(64, 29, 3), (10, 8, 0)])
def test_synthetic_data_identical_to_jax(num, max_nodes, seed):
    ours = synthetic_qm9_like(num, max_nodes=max_nodes, seed=seed)
    ref = jax_synthetic(num, max_nodes=max_nodes, seed=seed)
    assert set(ours.data) == set(ref.data)
    for k, v in ref.data.items():
        assert ours.data[k].dtype == v.dtype and np.array_equal(ours.data[k], v), k
    assert np.array_equal(ours.included_species, ref.included_species)
    kw = dict(batch_size=8, shuffle=True, drop_last=False, pad_to=max_nodes)
    for a, b in zip(iterate_dense_batches(ours, rng=np.random.default_rng(1), **kw),
                    jax_iterate(ref, rng=np.random.default_rng(1), **kw)):
        for field in ("x", "one_hot", "charges", "node_mask"):
            assert np.array_equal(getattr(a, field), np.asarray(getattr(b, field))), field


def test_cli_train_runs_on_cpu(tmp_path):
    from bio_diffusion_torch.cli.train import main
    from bio_diffusion_torch.ops import message_layer as ml

    before = dict(ml.launch_counts)
    trainer = main(TRAIN + ["--device=cpu", "--max-steps=2", f"--workdir={tmp_path}"])
    assert ml.launch_counts == before  # CPU tensors take the plain versions
    assert trainer.state.count == 2
    assert trainer.stats["steps"] == 2 and trainer.stats["eval_batches"] > 0
    with open(tmp_path / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    train_rows = [r for r in rows if r["train/loss"]]
    val_rows = [r for r in rows if r["valid/loss"]]
    assert train_rows and val_rows
    assert np.isfinite(float(train_rows[-1]["train/loss"])) and np.isfinite(float(val_rows[-1]["valid/loss"]))
    # the EMA twin moved off the weights it started from, by (1 - decay) of the steps
    moved = [(e - p).abs().max().item() for e, p in zip(trainer.evd_ema.parameters(), trainer.evd.parameters())]
    assert max(moved) > 0


def test_cli_train_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bio_diffusion_torch.cli.train import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(TRAIN + ["--device=cuda", "--max-steps=1", f"--workdir={tmp_path}"])


def test_profile_train_groups_only_the_port_kernels():
    from bio_diffusion_torch.cli.profile_train import group_times

    kernels = {
        "void (anonymous namespace)::bwd_rows_kernel<float>((anonymous namespace)::BwdParams<float>)": [9.0, 9.0],
        "(anonymous namespace)::proj_sum_kernel(const float *, int, int, int, int, (anonymous namespace)::ProjSumPlan, float *, float *)": [0.5, 9.0],
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(...)": [1.5, 480.0],
        "void (anonymous namespace)::message_layer_kernel<float>((anonymous namespace)::Params<float>)": [2.5, 9.0],
    }
    assert group_times(kernels) == {"message_layer": [2.5, 9.0], "message_layer_bwd": [9.5, 18.0]}


def test_profile_train_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bio_diffusion_torch.cli.profile_train import main

    with pytest.raises(SystemExit, match="unknown argument"):
        main(["--steps=1"])
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        main(["--precision=bf16"])


def test_port_training_imports_no_jax():
    code = (
        "import sys\n"
        "import bio_diffusion_torch.cli.train, bio_diffusion_torch.cli.profile_train\n"
        "import bio_diffusion_torch.train.loop\n"
        "import bio_diffusion_torch.train.step, bio_diffusion_torch.train.state\n"
        "import bio_diffusion_torch.data.batch, bio_diffusion_torch.data.synthetic\n"
        "import bio_diffusion_torch.config, bio_diffusion_torch.chem\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'bio_diffusion_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_serving_forward_sees_weights_after_an_optimizer_step():
    from bio_diffusion_torch.config.schema import OptimizerConfig
    from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
    from bio_diffusion_torch.train.state import TrainState
    from bio_diffusion_torch.train.torch_import import init_random_weights

    dyn = GCPNetDynamics(*tiny_configs())
    init_random_weights(dyn, 0)
    ema = copy.deepcopy(dyn).requires_grad_(False)
    xh, t, mask = (torch.from_numpy(a) for a in tiny_batch())
    with torch.no_grad():
        before = dyn(xh, t, mask)  # fills the packed cache
    state = TrainState(list(dyn.parameters()), list(ema.parameters()), OptimizerConfig(lr=1e-2))
    out = dyn(xh, t, mask)  # training forward: live weights
    state.apply_gradients(torch.autograd.grad(out.square().sum(), state.params))
    state.update_ema(0.5)
    for model in (dyn, ema):
        with torch.no_grad():
            served = model(xh, t, mask)
            fresh = copy.deepcopy(model)  # a copy has no packed cache yet
            fresh._packed = None
            expected = fresh(xh, t, mask)
        assert torch.equal(served, expected)
        assert not torch.allclose(served, before)


def test_build_digest_covers_included_headers(tmp_path):
    from bio_diffusion_torch.ops.build import SOURCE_DIR, source_digest

    for name in os.listdir(SOURCE_DIR):
        shutil.copy(SOURCE_DIR / name, tmp_path / name)
    src = tmp_path / "message_layer_bwd.cu"
    first = source_digest(src)
    assert source_digest(src) == first
    header = tmp_path / "message_layer_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert source_digest(src) != first
