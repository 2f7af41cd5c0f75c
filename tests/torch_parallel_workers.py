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


def tiny_cfgs(model=None, layer=None, **diffusion):
    """The tiny (model, module, layer, diffusion, dataloader) configs;
    ``diffusion``: fields of the diffusion config to set, ``model`` and
    ``layer`` those of the model and layer configs."""
    from bio_diffusion_torch.config import schema

    mc = schema.ModelConfig(h_hidden_dim=16, chi_hidden_dim=4, e_hidden_dim=8, xi_hidden_dim=2,
                            num_encoder_layers=2, **(model or {}))
    return (mc, schema.ModuleConfig(), schema.LayerConfig(**(layer or {})),
            schema.DiffusionConfig(num_timesteps=10, **diffusion), schema.DataloaderConfig())


def port_evd(state_dict, model=None, layer=None, **diffusion):
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
    from bio_diffusion_torch.train.torch_import import load_reference_state_dict

    cfgs = tiny_cfgs(model, layer, **diffusion)
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    load_reference_state_dict(evd, state_dict)
    return evd


def run_steps(dp, case):
    """``case``: ``state_dict``, ``table`` (log p(N)), ``steps`` (each a global
    batch, or a list of micro-batches), ``draws`` (a list a step, or None
    to draw from a generator seeded ``seed``), ``accum``, optionally
    ``diffusion`` (diffusion config fields) -> per-step loss and grad norm,
    the parameters and the EMA after the steps; ``{"error": message}``
    where an invariant check failed.  On a model axis (``dp.model > 1``)
    the state is sharded as the Trainer shards it and ``at_rest`` says what
    the rank held after the last step; the parameters, EMA and moments
    returned are the gathered ones."""
    from bio_diffusion_torch.config.schema import OptimizerConfig
    from bio_diffusion_torch.parallel.mesh import ModelShards
    from bio_diffusion_torch.train.state import TrainState
    from bio_diffusion_torch.train.step import make_train_step
    from bio_diffusion_torch.utils.debug import InvariantError

    diffusion, nets = case.get("diffusion", {}), {k: case.get(k) for k in ("model", "layer")}
    cfgs = tiny_cfgs(**nets, **diffusion)
    evd = port_evd(case["state_dict"], **nets, **diffusion)
    ema = port_evd(case["state_dict"], **nets, **diffusion).requires_grad_(False)
    state = TrainState(list(evd.parameters()), list(ema.parameters()), OptimizerConfig())
    if dp is not None and dp.model > 1:
        state.shard_(ModelShards(state.params, dp), (evd, ema))
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
    at_rest = None if state.shards is None else at_rest_elements(state)
    state.gather_params_(params=True, ema=True)
    names = [n for n, _ in evd.named_parameters()]
    return {"metrics": metrics,
            "params": {n: p.detach().numpy().copy() for n, p in evd.named_parameters()},
            "ema": {n: p.detach().numpy().copy() for n, p in ema.named_parameters()},
            "moments": {key: {n: t.detach().numpy().copy() for n, t in zip(names, ts)}
                        for key, ts in state.full_moments().items()},
            "count": state.count, "at_rest": at_rest}


def at_rest_elements(state):
    """Elements a rank's storage holds at rest: of the five copies (the
    parameter and EMA shards, the three moments), of the model's and the
    EMA twin's sharded parameters (released: 0), and the shard dims."""
    from bio_diffusion_torch.train.state import MOMENTS

    def stored(t):
        return t.untyped_storage().nbytes() // t.element_size()

    copies = [state.param_shards, state.ema_shards] + [getattr(state, k) for k in MOMENTS]
    fulls = [t for ts in (state.params, state.ema_params) for i, t in enumerate(ts) if state.shards.dims[i] is not None]
    return {"copies": sum(stored(t) for ts in copies for t in ts), "released": sum(stored(t) for t in fulls),
            "dims": list(state.shards.dims), "shapes": [tuple(p.shape) for p in state.params]}


def train_steps(rank, world, init, cases, num_model_shards=1):
    """``run_steps`` of each case on this rank of a gloo group (a
    ``data x model`` mesh with ``num_model_shards``)."""
    from bio_diffusion_torch.parallel.distributed import init_distributed, shutdown

    dp = init_distributed("cpu", init_method=init, rank=rank, world=world, num_model_shards=num_model_shards)
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


def chain(rank, world, init, calls):
    """``calls`` (``(function name, args)`` pairs) in order on this rank, each
    joining a group of its own -> their results."""
    return [globals()[name](rank, world, f"{init}.{i}", *args) for i, (name, args) in enumerate(calls)]


def mesh_error(rank, world, init, num_model_shards):
    """``init_distributed(num_model_shards=)`` on this rank -> the message of
    the ``ValueError`` it raised, or None."""
    from bio_diffusion_torch.parallel.distributed import init_distributed, shutdown

    try:
        init_distributed("cpu", init_method=init, rank=rank, world=world, num_model_shards=num_model_shards)
    except ValueError as e:
        return str(e)
    shutdown()
    return None


def sampling_around_a_step(rank, world, init, overrides, num_model_shards):
    """A Trainer at the tiny width (``overrides`` added; at world 1 without a
    group, ``init`` naming its workdir): a sampling evaluation, one train
    step, another sampling evaluation, then the EMA leaves that
    ``num_model_shards`` shards scaled by 0.9 (their shards alone on a model
    axis, where no version counter of the model's parameters moves) and a
    third evaluation -> the three evaluations' molecules (rank 0's; None on
    the others)."""
    from bio_diffusion_torch.config.build import build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.parallel.distributed import init_distributed, shutdown
    from bio_diffusion_torch.parallel.mesh import shard_dim
    from bio_diffusion_torch.train import loop
    from bio_diffusion_torch.utils.logging import MetricLoggers

    dp = None
    if world > 1:
        dp = init_distributed("cpu", init_method=init, rank=rank, world=world, num_model_shards=num_model_shards)
    samples, sample = [], loop.sample_molecules

    def recorded(*args, **kwargs):
        out = sample(*args, **kwargs)
        samples.append(out[0])
        return out

    loop.sample_molecules = recorded
    try:
        cfg = load_config(default_config_dir(), "train", TINY_OVERRIDES + list(overrides))
        trainer = loop.Trainer(build_experiment(cfg), f"{init[len('file://'):]}.wd{rank}", "cpu",
                               loggers=MetricLoggers(), dp=dp)
        trainer.init_state(resume=False)
        sizes = trainer.rng.bit_generator.state
        trainer.evaluate_sampling(0)
        batch = next(trainer._train_batches()).to(trainer.device)
        trainer.train_step(trainer.state, batch, trainer.step_generator())
        trainer.rng.bit_generator.state = sizes  # the same molecule sizes and draws again
        trainer.evaluate_sampling(0)
        state = trainer.state
        with torch.no_grad():
            for shard, full in zip(state.ema_shards, state.ema_params):
                if shard_dim(full.shape, num_model_shards) is not None:
                    shard.mul_(0.9)
        trainer.rng.bit_generator.state = sizes
        trainer.evaluate_sampling(0)
        return samples or None
    finally:
        loop.sample_molecules = sample
        if dp is not None:
            shutdown()


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
