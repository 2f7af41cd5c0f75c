"""Where the time of a training step goes, on one CUDA card.

Usage:
  python -m bio_diffusion_torch.cli.profile_train [--precision=fp32|bf16]

Builds the ``Trainer`` of ``configs/train.yaml`` with
``experiment=qm9_mol_gen_ddpm`` on the synthetic QM9-schema data (full
width, batch 64, N=29, weights drawn from the seed; metrics go to
``outputs/profile_train``) and takes 3 warm-up steps.  Then, in the same
process:

1. 4 Trainer steps timed with CUDA events, without the profiler;
2. 4 further steps under ``torch.profiler``, timed the same way.

For the profiled run it prints every device kernel's time per step, the
device-busy time (the sum of all device activity) and each one's share of
that run's own step time; the message-layer kernels are also summed into
their two wrappers.  The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List

WARMUP, STEPS = 3, 4
# device kernels of each hand-written wrapper (``csrc/*.cu``, whose kernels
# sit in an anonymous namespace, apart from PyTorch's of the same names)
KERNEL_GROUPS = {
    "message_layer": ("message_layer_kernel",),
    "message_layer_bwd": ("bwd_rows_kernel", "proj_sum_kernel", "weight_grad_kernel"),
}


def group_times(kernels: Dict[str, List[float]]) -> Dict[str, List[float]]:
    """:func:`device_times` summed into the hand-written wrappers -> name ->
    [ms per step, launches per step]."""
    out = {}
    for group, names in KERNEL_GROUPS.items():
        own = [v for k, v in kernels.items() if any(f"(anonymous namespace)::{n}" in k for n in names)]
        out[group] = [sum(v[0] for v in own), sum(v[1] for v in own)]
    return out


def group_kernel_ms(torch, fn, reps: int, group: str, names=None) -> Dict[str, float]:
    """Device ms per call of each kernel of one wrapper (``names``, by
    default ``KERNEL_GROUPS[group]``) over ``reps`` calls of ``fn`` under
    ``torch.profiler``, after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = device_times(prof.events(), reps)
    return {n: sum(v[0] for k, v in kernels.items() if f"(anonymous namespace)::{n}" in k)
            for n in (names or KERNEL_GROUPS[group])}


def _timed_steps(torch, trainer, steps: int) -> float:
    """ms per step of ``steps`` further Trainer steps, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    trainer.train_epoch(epoch=trainer.state.count, max_steps=trainer.state.count + steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def device_times(events, steps: int) -> Dict[str, List[float]]:
    """Device activity of a profile by name -> [ms per step, launches per step]."""
    from torch.autograd import DeviceType

    out: Dict[str, List[float]] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            acc = out.setdefault(e.name, [0.0, 0.0])
            acc[0] += e.time_range.elapsed_us() / 1000.0 / steps
            acc[1] += 1.0 / steps
    return out


def main(argv=None) -> Dict[str, object]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bio_diffusion_torch.config.build import build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.train.loop import Trainer

    argv = list(sys.argv[1:] if argv is None else argv)
    precision = "fp32"
    for arg in argv:
        if arg in ("--precision=fp32", "--precision=bf16"):
            precision = arg.partition("=")[2]
        else:
            print(__doc__.strip())
            raise SystemExit(0 if arg == "--help" else f"unknown argument {arg!r}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(default_config_dir(), "train", [
        "experiment=qm9_mol_gen_ddpm", "datamodule.dataloader_cfg.dataset=synthetic",
        f"trainer.precision={precision}"])
    trainer = Trainer(build_experiment(cfg), "outputs/profile_train", "cuda")
    trainer.init_state()
    trainer.train_epoch(epoch=0, max_steps=WARMUP)

    plain_ms = _timed_steps(torch, trainer, STEPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms = _timed_steps(torch, trainer, STEPS)
    kernels = device_times(prof.events(), STEPS)
    busy = sum(ms for ms, _ in kernels.values())
    groups = group_times(kernels)

    batch = trainer.exp.dataloader_cfg.batch_size
    print(f"{precision}: batch {batch}; {STEPS} steps {plain_ms:.3f} ms/step without the profiler, "
          f"{prof_ms:.3f} ms/step with it; device busy {busy:.3f} ms/step "
          f"({100 * busy / prof_ms:.1f}% of the profiled step); "
          f"{sum(n for _, n in kernels.values()):.0f} device activities per step")
    for g, (ms, n) in groups.items():
        print(f"  {g}: {ms:.3f} ms/step, {n:.0f} launches/step, {100 * ms / prof_ms:.1f}% of the profiled step")
    rest = prof_ms - sum(ms for ms, _ in groups.values())
    print(f"  everything else: {rest:.3f} ms/step, {100 * rest / prof_ms:.1f}% of the profiled step "
          f"({prof_ms - busy:.3f} ms of it device-idle)")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ms:9.3f} ms/step {n:8.1f}/step  {name[:110]}")
    result = {
        "precision": precision, "batch": batch, "steps": STEPS, "ms_per_step": plain_ms,
        "profiled_ms_per_step": prof_ms, "device_busy_ms_per_step": busy,
        "kernels": {g: {"ms_per_step": ms, "launches_per_step": n, "share_of_profiled_step": ms / prof_ms}
                    for g, (ms, n) in groups.items()},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
