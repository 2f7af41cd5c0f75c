"""Training-step benchmark: the module forward, the packed forward through
the plain message layer, and the packed forward through the kernels.

Counterpart of ``scripts/bench_train_step.py``, whose ``module`` / ``xla`` /
``pallas`` paths are here ``module`` / ``plain`` / ``kernel``:

* ``module``: the module forward (``GCPNetDynamics(fast="off")``, GCPs as
  PyTorch ops; no kernel);
* ``plain``: the packed forward with its message layers through
  ``ops/message_layer.py::message_layer_plain`` (autograd for the backward;
  selected at construction, ``use_kernels=False``, as the JAX script passes
  ``use_pallas=False``);
* ``kernel``: the packed forward with the message-layer kernels, forward
  and backward (what ``cli.train`` runs); needs a CUDA device.

Every path starts from the same weights (drawn from seed 0) and takes the
whole Trainer step (loss -> grad -> adaptive clip -> AMSGrad -> EMA) on one
synthetic batch at the flagship shape (sizes drawn in [N-10, N]), each step's
draws from a generator seeded by its index, so step 1's losses compare
across paths.

Usage:
  python -m bio_diffusion_torch.cli.bench_train_step [--batch 64] [--nodes 29] [--layers 9]
      [--precision bf16|fp32] [--paths module,plain,kernel] [--steps 20]
      [--curve K]  # print the loss every K steps
      [--geom]     # geom_mol_gen_ddpm (4 layers, Se=16, Ve=8, 16 types, no charges; B=8, N=181)
      [--split]    # fwd (loss only) / bwd (grad - fwd) / clip+optimizer+EMA (step - grad)
                   # of the kernel path (of the last path without it), the
                   # step's logical FLOPs counted on the module path
                   # (torch.utils.flop_counter, the same math) and MFU
                   # against the H100's dense peak for the precision
      [--device cuda|cpu] [key=value config overrides ...]

``--remat`` and ``--donate`` have no meaning here and are refused.  Prints
one line per path (ms/step, steps/s, the first step's seconds, the losses,
the kernels' launches) and one JSON line with the numbers.
"""

from __future__ import annotations

import copy
import json
import sys
import time

import numpy as np

PATHS = ("module", "plain", "kernel")
# the H100's dense peak FLOP/s by precision (PERF.md's bounds use the same)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def build_experiment_for(geom: bool, precision: str, layers, overrides=()):
    from bio_diffusion_torch.config.build import build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config

    extra = [f"model.model_cfg.num_encoder_layers={layers}"] if layers is not None else []
    cfg = load_config(default_config_dir(), "train",
                      [f"experiment={'geom_mol_gen_ddpm' if geom else 'qm9_mol_gen_ddpm'}",
                       f"trainer.precision={precision}", *extra, *overrides])
    return build_experiment(cfg)


def path_evd(exp, path: str, state_dict):
    """The EVD of one path with the weights ``state_dict``, on the CPU."""
    from bio_diffusion_torch.config.build import build_evd
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_torch.models.gcpnet import GCPNetDynamics

    if path == "plain":
        cdt = "bfloat16" if exp.trainer.precision in ("bf16", "bfloat16") else None
        dyn = GCPNetDynamics(exp.model_cfg, exp.module_cfg, exp.layer_cfg, exp.diffusion_cfg, exp.dataloader_cfg,
                             compute_dtype=cdt, fast="on", use_kernels=False)
        evd = EquivariantVariationalDiffusion(dyn, exp.diffusion_cfg, exp.dataloader_cfg)
    else:
        evd = build_evd(exp, fast="off" if path == "module" else "on")
    evd.load_state_dict(state_dict)
    return evd


def synthetic_batch(exp, batch: int, nodes: int, device):
    """The JAX script's batch: sizes in [max(N-10, 3), N], positions and
    types from ``default_rng(0)``, charges = type + 1 where the config has a
    charge channel -> (DenseMolBatch on ``device``, the sizes)."""
    from bio_diffusion_torch.config.schema import compute_num_atom_types
    from bio_diffusion_torch.data.batch import DenseMolBatch

    dl = exp.dataloader_cfg
    k_types = compute_num_atom_types(dl)
    rng = np.random.default_rng(0)
    num_atoms = rng.integers(max(nodes - 10, 3), nodes + 1, size=batch)
    mask = (np.arange(nodes)[None, :] < num_atoms[:, None]).astype(np.float32)
    x = rng.normal(size=(batch, nodes, 3)).astype(np.float32) * mask[..., None]
    types = rng.integers(0, k_types, size=(batch, nodes))
    one_hot = np.eye(k_types, dtype=np.float32)[types] * mask[..., None]
    charges = ((types + 1).astype(np.float32)[..., None] * mask[..., None])[..., : int(dl.include_charges)]
    return DenseMolBatch(x=x, one_hot=one_hot, charges=charges, node_mask=mask).to(device), num_atoms


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in ("--remat", "--donate"):
        if flag in argv:
            raise SystemExit(f"{flag} has no meaning in the PyTorch port (no remat or buffer donation); drop it")

    def opt(flag, default):
        return argv[argv.index(flag) + 1] if flag in argv else default

    overrides = [a for a in argv if "=" in a and not a.startswith("-")]  # key=value config overrides
    geom = "--geom" in argv
    batch = int(opt("--batch", 8 if geom else 64))
    nodes = int(opt("--nodes", 181 if geom else 29))
    layers = opt("--layers", None)
    precision = "bf16" if opt("--precision", "bf16") in ("bf16", "bfloat16") else "fp32"
    steps = int(opt("--steps", 20))
    curve = int(opt("--curve", 0))
    paths = opt("--paths", ",".join(PATHS)).split(",")
    if set(paths) - set(PATHS):
        raise SystemExit(f"unknown paths {sorted(set(paths) - set(PATHS))}; choose from {PATHS}")

    import torch

    from bio_diffusion_torch.config.build import build_evd
    from bio_diffusion_torch.models.distributions import NumNodesDistribution
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train.state import TrainState
    from bio_diffusion_torch.train.step import make_train_step
    from bio_diffusion_torch.train.torch_import import init_random_weights

    device = torch.device(opt("--device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available (there is no CPU fallback)")
    if "kernel" in paths and device.type != "cuda":
        raise SystemExit("the kernel path needs a CUDA device; on the CPU take --paths module,plain")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    exp = build_experiment_for(geom, precision, layers, overrides)
    dc, dl = exp.diffusion_cfg, exp.dataloader_cfg
    ref = build_evd(exp, fast="off")
    init_random_weights(ref, 0)
    weights = copy.deepcopy(ref.state_dict())
    b, num_atoms = synthetic_batch(exp, batch, nodes, device)
    hist = {int(n): int(c) for n, c in zip(*np.unique(num_atoms, return_counts=True))}
    table = NumNodesDistribution(hist).log_prob_table
    n_params = sum(p.numel() for p in ref.parameters())
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"# device={device} ({name}) B={batch} N={nodes} L={exp.model_cfg.num_encoder_layers} {precision} "
          f"params={n_params:,}", file=sys.stderr)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def bench(path):
        evd = path_evd(exp, path, weights).to(device).train()
        ema = copy.deepcopy(evd).eval().requires_grad_(False)
        state = TrainState(list(evd.parameters()), list(ema.parameters()), exp.optimizer)
        step = make_train_step(evd, dc, dl, table, ema_decay=exp.trainer.ema_decay,
                               clip_gradients=exp.module_cfg.clip_gradients)
        before = dict(ml.launch_counts)
        t0 = time.perf_counter()
        loss1 = float(step(state, b, gen(1))["loss"])
        first_s = time.perf_counter() - t0
        losses = []
        sync()
        t0 = time.perf_counter()
        for i in range(steps):
            metrics = step(state, b, gen(2 + i))
            if curve and (i + 1) % curve == 0:
                losses.append(float(metrics["loss"]))
                print(f"#   {path} step {i + 2}: loss={losses[-1]:.4f}", file=sys.stderr)
        loss = float(metrics["loss"]) if steps else loss1
        sync()
        dt = (time.perf_counter() - t0) / max(steps, 1)
        counts = {k: ml.launch_counts[k] - before[k] for k in before}
        print(f"{path}: {dt * 1e3:.3f} ms/step ({1.0 / dt:.2f} steps/s) first={first_s:.3f}s loss1={loss1:.6f} "
              f"loss={loss:.4f} launches fwd={counts['message_layer']} bwd={counts['message_layer_bwd']} "
              f"over {1 + steps} steps")
        return {"ms_per_step": 1e3 * dt, "first_step_s": first_s, "loss_step1": loss1, "loss_last": loss,
                "curve": losses, "launches": {"message_layer": counts["message_layer"],
                                              "message_layer_bwd": counts["message_layer_bwd"]},
                "steps_timed": steps}

    results = {p: bench(p) for p in PATHS if p in paths}
    if "module" in results:
        for p, r in results.items():
            if p != "module":
                print(f"# speedup {p} vs module: {results['module']['ms_per_step'] / r['ms_per_step']:.2f}x")

    out = {"device": name, "batch": batch, "nodes": nodes, "layers": exp.model_cfg.num_encoder_layers,
           "precision": precision, "steps": steps, "paths": results}
    if "--split" in argv:
        out["split"] = split(torch, exp, weights, b, table, "kernel" if "kernel" in paths else paths[-1],
                             results, steps, device, sync, precision)
    print(json.dumps(out))
    return out


def split(torch, exp, weights, b, table, path, results, steps, device, sync, precision):
    """fwd (the loss alone, graph built as in training) / bwd (loss and
    gradients, less fwd) / glue (the whole step, less loss and gradients) of
    ``path``, each timed over ``steps`` calls after one warm-up; the step's
    logical FLOPs from ``FlopCounterMode`` on the module path; MFU against
    ``PEAK_FLOPS[precision]``."""
    from torch.utils.flop_counter import FlopCounterMode

    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train.state import global_norm
    from bio_diffusion_torch.train.step import make_loss_fn

    dc, dl = exp.diffusion_cfg, exp.dataloader_cfg
    reps = max(steps, 1)

    def fns(evd):
        loss_fn = make_loss_fn(evd, dc, dl, table, training=True)
        params = list(evd.parameters())
        g = torch.Generator(device=device)

        def fwd():
            return loss_fn(b, g.manual_seed(1))[0]

        def grad():
            loss = fwd()
            return loss, global_norm(torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True))

        return fwd, grad

    def time_it(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps

    evd = path_evd(exp, path, weights).to(device).train()
    fwd, grad = fns(evd)
    before = dict(ml.launch_counts)
    fwd_s, grad_s = time_it(fwd), time_it(grad)
    launches = {k: ml.launch_counts[k] - before[k] for k in ("message_layer", "message_layer_bwd")}
    step_s = results[path]["ms_per_step"] / 1e3
    module = path_evd(exp, "module", weights).to(device).train()
    m_fwd, m_grad = fns(module)
    with FlopCounterMode(display=False) as fc:
        m_fwd()
    flops_fwd = float(fc.get_total_flops())
    with FlopCounterMode(display=False) as fc:
        m_grad()
    flops_grad = float(fc.get_total_flops())
    peak = PEAK_FLOPS[precision]
    out = {"path": path, "fwd_ms": 1e3 * fwd_s, "bwd_ms": 1e3 * (grad_s - fwd_s), "glue_ms": 1e3 * (step_s - grad_s),
           "step_ms": 1e3 * step_s, "flops_fwd": flops_fwd, "flops_fwd_bwd": flops_grad,
           "mfu_step": flops_grad / (step_s * peak), "mfu_fwd_bwd": flops_grad / (grad_s * peak),
           "peak_flops": peak, "launches": launches}
    print(f"split ({path}): fwd={out['fwd_ms']:.3f} ms  bwd={out['bwd_ms']:.3f} ms  "
          f"clip+opt+ema={out['glue_ms']:.3f} ms  (step={out['step_ms']:.3f} ms)")
    print(f"flops: fwd={flops_fwd:.3e}  fwd+bwd={flops_grad:.3e}  MFU(step)={100 * out['mfu_step']:.2f}%  "
          f"MFU(fwd+bwd)={100 * out['mfu_fwd_bwd']:.2f}%  ({precision} peak {peak / 1e12:.0f} TFLOP/s)")
    return out


if __name__ == "__main__":
    main()
