"""Ranks of the data-parallel tests (``test_torch_parallel*.py``).

Each rank is a fresh ``python`` process that imports torch and the port
only (no JAX): ``run_group`` writes the arguments to a directory, starts
``world`` processes of this file, which join a gloo group through a
``FileStore`` in that directory (no TCP port), run one of the functions
below and write their results there.  The group is killed past its
timeout, so a deadlock fails the test instead of hanging the run.
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys
import time
import traceback

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# S=16, V=4, Se=8, Ve=2, two layers, T=10 (tests/test_torch_common.py's)
TINY_OVERRIDES = [
    "datamodule.dataloader_cfg.dataset=synthetic",
    "model.model_cfg.h_hidden_dim=16",
    "model.model_cfg.chi_hidden_dim=4",
    "model.model_cfg.e_hidden_dim=8",
    "model.model_cfg.xi_hidden_dim=2",
    "model.model_cfg.num_encoder_layers=2",
    "model.diffusion_cfg.num_timesteps=10",
]


def run_group(fn_name: str, world: int, tmp_dir: str, *args, timeout: float = 120.0):
    """Run ``fn_name(dp, *args)`` on ``world`` ranks -> each rank's result."""
    os.makedirs(tmp_dir, exist_ok=True)
    torch.save(args, os.path.join(tmp_dir, "args.pt"))
    child_env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                     PYTHONPATH=os.pathsep.join([REPO, HERE, os.environ.get("PYTHONPATH", "")]))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        child_env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), fn_name, str(r), str(world), tmp_dir],
                              env=child_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.time() + timeout
    outputs, timed_out = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outputs.append(out.decode(errors="replace"))
    if timed_out or any(p.returncode != 0 for p in procs):
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{o[-3000:]}"
                          for r, (p, o) in enumerate(zip(procs, outputs)))
        raise RuntimeError(f"{fn_name} at world {world} {'timed out' if timed_out else 'failed'}:\n{tails}")
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _main(argv):
    fn_name, rank, world, tmp_dir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    args = torch.load(os.path.join(tmp_dir, "args.pt"), weights_only=False)
    try:
        result = globals()[fn_name](rank, world, f"file://{os.path.join(tmp_dir, 'store')}", *args)
    except Exception:  # noqa: BLE001 — reported to the parent through the exit code and output
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    torch.save(result, os.path.join(tmp_dir, f"rank{rank}.pt"))


# -- models and steps (shared with the parent, which runs world 1) ------------------


def tiny_cfgs(**diffusion):
    """The tiny (model, module, layer, diffusion, dataloader) configs;
    ``diffusion``: fields of the diffusion config to set."""
    from bio_diffusion_torch.config import schema

    mc = schema.ModelConfig(h_hidden_dim=16, chi_hidden_dim=4, e_hidden_dim=8, xi_hidden_dim=2,
                            num_encoder_layers=2)
    return (mc, schema.ModuleConfig(), schema.LayerConfig(), schema.DiffusionConfig(num_timesteps=10, **diffusion),
            schema.DataloaderConfig())


def port_evd(state_dict, **diffusion):
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
    from bio_diffusion_torch.train.torch_import import load_reference_state_dict

    cfgs = tiny_cfgs(**diffusion)
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    load_reference_state_dict(evd, state_dict)
    return evd


def run_steps(dp, case):
    """``case``: ``state_dict``, ``table`` (log p(N)), ``steps`` (each a global
    batch, or a list of micro-batches), ``draws`` (a list a step, or None
    to draw from a generator seeded ``seed``), ``accum``, optionally
    ``diffusion`` (diffusion config fields) -> per-step loss and grad norm,
    the parameters and the EMA after the steps; ``{"error": message}``
    where an invariant check failed."""
    from bio_diffusion_torch.config.schema import OptimizerConfig
    from bio_diffusion_torch.train.state import TrainState
    from bio_diffusion_torch.train.step import make_train_step
    from bio_diffusion_torch.utils.debug import InvariantError

    diffusion = case.get("diffusion", {})
    cfgs = tiny_cfgs(**diffusion)
    evd = port_evd(case["state_dict"], **diffusion)
    ema = port_evd(case["state_dict"], **diffusion).requires_grad_(False)
    state = TrainState(list(evd.parameters()), list(ema.parameters()), OptimizerConfig())
    step = make_train_step(evd, cfgs[3], cfgs[4], case["table"], accumulate_grad_batches=case["accum"], dp=dp)
    generator = torch.Generator().manual_seed(case.get("seed", 0))
    metrics = []
    for i, batch in enumerate(case["steps"]):
        draws = None if case["draws"] is None else case["draws"][i]
        try:
            m = step(state, batch, generator, draws)
        except InvariantError as e:
            return {"error": str(e)}
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "max_grad_norm")})
    return {"metrics": metrics,
            "params": {n: p.detach().numpy().copy() for n, p in evd.named_parameters()},
            "ema": {n: p.detach().numpy().copy() for n, p in ema.named_parameters()},
            "count": state.count}


def train_steps(rank, world, init, cases):
    """``run_steps`` of each case on this rank of a gloo group."""
    from bio_diffusion_torch.parallel.distributed import init_distributed, shutdown

    dp = init_distributed("cpu", init_method=init, rank=rank, world=world)
    try:
        return {name: run_steps(dp, case) for name, case in cases.items()}
    finally:
        shutdown()


def broadcast_init(rank, world, init, seeds):
    """A Trainer on synthetic data at the tiny width whose weights are drawn
    from ``seeds[rank]``: its state after ``init_state``."""
    from bio_diffusion_torch.config.build import build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.parallel.distributed import init_distributed, shutdown
    from bio_diffusion_torch.train.loop import Trainer
    from bio_diffusion_torch.utils.logging import MetricLoggers

    dp = init_distributed("cpu", init_method=init, rank=rank, world=world)
    try:
        cfg = load_config(default_config_dir(), "train", TINY_OVERRIDES + [f"seed={seeds[rank]}"])
        trainer = Trainer(build_experiment(cfg), os.path.join(os.path.dirname(init[len("file://"):]), f"wd{rank}"),
                          "cpu", loggers=MetricLoggers(), dp=dp)
        st = trainer.init_state(resume=False)
        return {key: [t.detach().numpy().copy() for t in getattr(st, key)]
                for key in ("params", "ema_params", "mu", "nu", "nu_max")}
    finally:
        shutdown()


def cli_runs(rank, world, init, runs):
    """``cli.train.main`` runs in order on this rank, as torchrun would
    launch them (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``), each joining
    its own group (``--dist-init``) -> per run: the state, the checkpoint
    saves of this rank, the epochs validated and rank 0's logged rows."""
    from bio_diffusion_torch.cli import train
    from bio_diffusion_torch.train import loop

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    saves, epochs = [], []
    orig_save, orig_validate = loop.save_checkpoint, loop.Trainer.validate

    def save(*args, **kwargs):
        saves.append(args[3].count)
        return orig_save(*args, **kwargs)

    def validate(self, epoch, *args, **kwargs):
        epochs.append(epoch)
        return orig_validate(self, epoch, *args, **kwargs)

    loop.save_checkpoint, loop.Trainer.validate = save, validate
    out = []
    for i, args in enumerate(runs):
        saves.clear()
        epochs.clear()
        trainer = train.main(args + [f"--dist-init={init}.{i}"])
        out.append(trainer_summary(trainer, saves, epochs))
    return out


def trainer_summary(trainer, saves=(), epochs=()):
    st = trainer.state
    return {"count": st.count, "start_step": trainer.start_step, "saves": list(saves), "epochs": list(epochs),
            "params": [p.detach().numpy().copy() for p in st.params],
            "ema": [p.detach().numpy().copy() for p in st.ema_params],
            "rows": copy.deepcopy(trainer.loggers.loggers[0].rows) if trainer.loggers.loggers else None}


if __name__ == "__main__":
    _main(sys.argv[1:])
    sys.stdout.flush()
    os._exit(0)  # no teardown of the group's threads
