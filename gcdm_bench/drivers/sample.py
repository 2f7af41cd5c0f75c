"""Sampling cells: whole sampler batches through ``SegmentedSampler.run``."""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from gcdm_bench import checks, traffic, yardstick
from gcdm_bench.program import Run, bound_s, experiment, num_features, peak_bytes, peak_flops, reset_peak, sync, \
    traced_passes, weights


def drive(run: Run) -> Dict:
    from bio_diffusion_torch.config.build import build_evd
    from bio_diffusion_torch.train.sampling import SegmentedSampler, make_node_mask

    cfg, dev = run.config, run.device
    tr = traffic.sample_traffic(run.spec, run.seed)
    exp = experiment(cfg, run.seed)
    state = weights(cfg, run.seed, dev)
    evd = build_evd(exp)
    evd.load_state_dict(state, strict=True)
    evd = evd.to(dev).eval().requires_grad_(False)
    sampler = SegmentedSampler(evd, dev)
    if run.fault == "frozen":
        evd.reverse_segment = lambda z, *args, **kwargs: (z, kwargs.get("self_cond"))
    nf, T = num_features(cfg), tr.num_timesteps
    b = len(tr.batches[0])

    def draws(k: int, steps: int, pad: int) -> torch.Tensor:
        gen = torch.Generator(device=dev).manual_seed(traffic.torch_seed(run.seed, 30, k))
        return torch.randn(traffic.sample_draws_shape(steps, b, pad, nf), generator=gen, device=dev)

    def run_batch(k: int, steps: int, noise_key: int):
        """One sampler batch, its chain of states kept (the sampler's frames)."""
        sizes, pad = tr.batches[k % len(tr.batches)], tr.pads[k % len(tr.pads)]
        xh, frames = sampler.run(make_node_mask(sizes, pad), None, num_timesteps=steps,
                                 noises=list(draws(noise_key, steps, pad).unbind(0)), frame_steps=range(steps))
        if run.fault == "answer":
            xh[:, 0, :3] += 2.0
        return xh, frames

    # set-up: one reverse step at each padded size the traffic reaches
    reset_peak(dev)
    for pad in tr.shapes:
        run_batch(tr.pads.index(pad), 1, (1 << 31) + pad)
    sync(dev)
    setup_s = time.perf_counter() - run.t_start

    outputs: List[tuple] = []
    marks = [time.perf_counter()]
    while True:
        outputs.append(run_batch(len(outputs), T, len(outputs)))
        marks.append(time.perf_counter())
        if marks[-1] - marks[0] >= run.seconds:
            break
    window_s = marks[-1] - marks[0]
    print(f"batch seconds: {[round(b - a, 4) for a, b in zip(marks, marks[1:])]}", file=sys.stderr)
    done = len(outputs)
    summary = None

    def one_more() -> None:
        outputs.append(run_batch(len(outputs), T, len(outputs)))

    if run.traced:  # then two more batches, each under the profiler
        summary = traced_passes(run, one_more, set())
    peak = peak_bytes(dev)
    del sampler, evd
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    sizes = [tr.batches[k % len(tr.batches)] for k in range(len(outputs))]
    layers = cfg["model_cfg"]["num_encoder_layers"]
    spanned = sizes[-1:] if run.traced else []  # the batch whose kernels were found by span
    b1_flops = sum(yardstick.message_layer_flops(cfg, s) for s in spanned) * layers * (T + 1)
    b1_bytes = sum(yardstick.message_layer_bytes(cfg, s, backward=False) for s in spanned) * layers * (T + 1)
    readings = checks.sample_readings(run, tr, outputs, state, draws)
    failed = sum(int(not np.isfinite(x).all()) for xh, _ in outputs for x in xh)
    run.out.update(
        setup_s=setup_s, window_s=window_s, peak_bytes=peak, attempted=len(outputs) * b, failed=failed,
        e2e={"sample_evals_per_s": done * b * (T + 1) / window_s, "peak_mem_gib": peak / 2 ** 30,
             "setup_s": setup_s},
        readings=readings, trace=summary,
        ctx={"trace": summary, "window_s": window_s, "reverse_steps": T if run.traced else 0,
             "denoiser_calls": T + 1 if run.traced else 0,
             "model_flops": sum(yardstick.denoiser_flops(cfg, s) for s in sizes[:done]) * (T + 1),
             "b1_bound_s": bound_s(run, b1_flops, b1_bytes), "peak_flops": peak_flops(run)})
    return run.out
