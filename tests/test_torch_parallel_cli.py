"""``cli.train`` under a 2-process gloo launch on the CPU.

Two ranks (``torch_parallel_workers.cli_runs``: ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` as torchrun sets them, a ``FileStore`` rendezvous through
``--dist-init``) run the tiny QM9 model on synthetic data, and the same runs
go through ``cli.train.main`` in this process without a launcher (world 1):

* 2 steps: both ranks hold world 1's state (float32, atol 1e-6 on the
  parameters; rtol 1e-6 on the logged loss), rank 0 alone logs and writes
  exactly one checkpoint set;
* a resume at world 2 (2 steps, then a second run to 4 on the same workdir)
  equal to the same resume at world 1 (the port restarts the data order on
  resume, as the JAX package does, so the reference is the resumed run at
  world 1);
* a step's draws depend on its count alone: on the same batches
  (``trainer.overfit_batches=2``, the same two batches every epoch), 2
  steps and a resumed run to 4 equal 4 uninterrupted steps, at world 1 (bit
  for bit) and at world 2;
* early stopping stops both ranks at the same epoch as world 1;
* one process with ``trainer.num_model_shards=2`` trains as with 1.
"""

import os

import numpy as np
import pytest

from torch_parallel_workers import TINY_OVERRIDES, run_group, trainer_summary

BASE = TINY_OVERRIDES + ["datamodule.dataloader_cfg.batch_size=8", "trainer.limit_train_batches=2",
                         "trainer.limit_val_batches=1", "trainer.check_val_every_n_epoch=1",
                         "model.diffusion_cfg.sample_during_training=false", "--device=cpu"]
SAME_BATCHES = ["trainer.overfit_batches=2"]
EARLY = ["trainer.early_stopping_monitor=val/loss", "trainer.early_stopping_patience=1",
         "trainer.early_stopping_min_delta=1e9", "trainer.min_epochs=1", "--max-epochs=5"]
TOL_PARAMS = dict(rtol=0, atol=1e-6)


def plans(root):
    """The runs in order: (name, args)."""
    return [("two_steps", BASE + ["--max-steps=2", f"--workdir={root}/a"]),
            ("resume_first", BASE + ["--max-steps=2", f"--workdir={root}/b"]),
            ("resume_second", BASE + ["--max-steps=4", f"--workdir={root}/b"]),
            ("early_stop", BASE + EARLY + [f"--workdir={root}/c"]),
            ("uninterrupted", BASE + SAME_BATCHES + ["--max-steps=4", f"--workdir={root}/d"]),
            ("same_first", BASE + SAME_BATCHES + ["--max-steps=2", f"--workdir={root}/e"]),
            ("same_resumed", BASE + SAME_BATCHES + ["--max-steps=4", f"--workdir={root}/e"])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from bio_diffusion_torch.cli import train

    world1_root, world2_root = tmp_path_factory.mktemp("world1"), tmp_path_factory.mktemp("world2")
    world1 = {name: trainer_summary(train.main(args)) for name, args in plans(world1_root)}
    names, args = zip(*plans(world2_root))
    ranks = run_group("cli_runs", 2, str(tmp_path_factory.mktemp("group")), list(args))
    world2 = [dict(zip(names, r)) for r in ranks]
    return {"world1": world1, "world2": world2, "root": world2_root}


def assert_same_state(a, b, what, **tol):
    for key in ("params", "ema"):
        for i, (x, y) in enumerate(zip(a[key], b[key])):
            if tol:
                np.testing.assert_allclose(x, y, **tol, err_msg=f"{what}: {key} {i}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{what}: {key} {i}")


def test_two_ranks_train_as_one(runs):
    w1, (r0, r1) = runs["world1"]["two_steps"], [w["two_steps"] for w in runs["world2"]]
    assert r0["count"] == r1["count"] == w1["count"] == 2
    assert_same_state(r0, r1, "rank 1 vs rank 0")
    assert_same_state(r0, w1, "world 2 vs world 1", **TOL_PARAMS)
    assert r1["rows"] is None  # only rank 0 logs
    ours = [r["train/loss"] for r in r0["rows"] if "train/loss" in r]
    ref = [r["train/loss"] for r in w1["rows"] if "train/loss" in r]
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    val = [r["valid/loss"] for r in r0["rows"] if "valid/loss" in r]
    np.testing.assert_allclose(val, [r["valid/loss"] for r in w1["rows"] if "valid/loss" in r], rtol=1e-5)


def test_one_checkpoint_set_written_by_rank_zero(runs):
    r0, r1 = [w["two_steps"] for w in runs["world2"]]
    assert r0["saves"] == [2] and r1["saves"] == []
    ckpt_dir = os.path.join(runs["root"], "a", "checkpoints")
    assert sorted(os.listdir(ckpt_dir)) == ["step_2.pt"]
    assert sorted(f for f in os.listdir(os.path.join(runs["root"], "a")) if f.endswith(".csv")) == ["metrics.csv"]


def test_resume_at_world_two_equals_world_one(runs):
    w1 = runs["world1"]["resume_second"]
    for rank, w in enumerate(runs["world2"]):
        first, second = w["resume_first"], w["resume_second"]
        assert (first["count"], second["start_step"], second["count"]) == (2, 2, 4), f"rank {rank}"
    assert w1["start_step"] == 2
    r0, r1 = [w["resume_second"] for w in runs["world2"]]
    assert_same_state(r0, r1, "rank 1 vs rank 0")
    assert_same_state(r0, w1, "world 2 vs world 1", **TOL_PARAMS)


@pytest.mark.parametrize("world", [1, 2])
def test_resume_continues_the_uninterrupted_draws(runs, world):
    """2 steps, then a resumed run to 4, on the same batches, equal 4
    uninterrupted steps: step k draws what it draws without the resume."""
    if world == 1:
        ref, resumed = runs["world1"]["uninterrupted"], runs["world1"]["same_resumed"]
        tol = {}
    else:
        ref = runs["world1"]["uninterrupted"]
        resumed = runs["world2"][0]["same_resumed"]
        assert_same_state(resumed, runs["world2"][1]["same_resumed"], "rank 1 vs rank 0")
        assert_same_state(runs["world2"][0]["uninterrupted"], ref, "world 2 vs world 1", **TOL_PARAMS)
        tol = TOL_PARAMS
    assert (resumed["start_step"], resumed["count"], ref["count"]) == (2, 4, 4)
    assert_same_state(resumed, ref, f"resumed vs uninterrupted at world {world}", **tol)


def test_early_stopping_stops_both_ranks_together(runs):
    w1 = runs["world1"]["early_stop"]
    r0, r1 = [w["early_stop"] for w in runs["world2"]]
    # validated after epochs 0 and 1; the second check did not improve by 1e9
    assert r0["epochs"] == r1["epochs"] == [0, 1]
    assert r0["count"] == r1["count"] == w1["count"] == 4
    assert_same_state(r0, w1, "world 2 vs world 1", **TOL_PARAMS)


def test_use_mesh_false_under_a_launcher_raises(monkeypatch, tmp_path):
    from bio_diffusion_torch.cli import train

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="use_mesh=false"):
        train.main(BASE + ["trainer.use_mesh=false", "--max-steps=1", f"--workdir={tmp_path}"])


def test_model_shards_on_one_process_train_unsharded(runs, tmp_path):
    """One process with ``trainer.num_model_shards=2`` has no model axis (JAX's
    ``default_mesh`` is None on one device): it trains exactly as
    ``num_model_shards=1`` does and says so in one log line."""
    import logging

    from bio_diffusion_torch.cli import train

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    train.log.addHandler(handler)
    try:
        ours = trainer_summary(train.main(BASE + ["trainer.num_model_shards=2", "--max-steps=2",
                                                  f"--workdir={tmp_path}"]))
    finally:
        train.log.removeHandler(handler)
    assert sum("training unsharded" in r.getMessage() for r in records) == 1
    assert ours["count"] == 2 and ours["start_step"] == 0
    assert_same_state(ours, runs["world1"]["two_steps"], "num_model_shards=2 vs 1 on one process")
