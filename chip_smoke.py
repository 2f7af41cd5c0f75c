#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one), prints the card's
   name and power limit, and turns TF32 off.
2. Builds the CUDA kernels from ``bio_diffusion_torch/csrc`` (nvcc, sm_90a).
3. Holds the message-layer kernel against its plain PyTorch version at full
   QM9 width (S=256, V=32, Se=64, Ve=16, 4 message GCPs), in float32 and
   bfloat16, at B=8 with N=19 and N=29, on a padded batch and at N=64; then
   times both at B=8 and B=250, N=19, bfloat16.
4. Checks the full-width denoiser on the card (kernel) against the same
   weights on the CPU (plain version), float32, on a small batch.
5. Drives the main path: ``cli.serve.build_server`` on ``configs/serve.yaml``
   (bf16, weights drawn from seed 0, batch 8), one warmed bucket, then
   requests through ``MoleculeServer.generate``: 8 molecules at the model's
   T=1000, a seeded pair at T=50 that must match exactly, and a
   distribution-sized request at T=50.  The kernel's launch count must show
   9 launches per denoiser call of every executed batch.
6. Decodes a padded batch through the server's sampler and checks the
   molecules: finite, CoM-free, padded rows 0, one type per real atom,
   integer charges.

Prints one JSON line of per-kernel results, then, last, the device line.
Any failure raises and the exit code is non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# tolerances of kernel vs plain version, relative to max|plain|: float32 with
# TF32 off differs only in summation order; bfloat16 rounds at other points
# than the plain version (which rounds after every op), ~1 bf16 ulp of 2^-8
TOL_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# full-width denoiser, card vs CPU, float32, relative to max|CPU output|
TOL_DENOISER_REL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def qm9_experiment(precision: str):
    from bio_diffusion_tpu.config.build import build_experiment
    from bio_diffusion_tpu.config.loader import default_config_dir, load_config

    cfg = load_config(default_config_dir(), "serve", [f"trainer.precision={precision}"])
    return build_experiment(cfg)


def kernel_inputs(torch, evd, b, n, dtype, padded, seed):
    """Layer-0 packed weights of the full-width model and seeded random
    node/edge inputs, on the card."""
    from bio_diffusion_torch.ops.message_layer import pack_chain_weights, pack_gcp1_weights

    mc = evd.dynamics_network.model_cfg
    mp = evd.dynamics_network.interaction_layers[0].interaction
    g1 = pack_gcp1_weights(mp.message_fusion[0], mc.h_hidden_dim, mc.chi_hidden_dim,
                           mc.xi_hidden_dim, dtype)
    chain = pack_chain_weights(mp.message_fusion[1:], mp.scalar_message_attention[0], dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    mask = torch.ones(b, n, device=dev)
    if padded:
        mask[0, n - 5:] = 0
        mask[b - 1, n - 1:] = 0
    em = (mask[:, :, None] * mask[:, None, :]).reshape(b, n * n, 1)
    se, ve = mc.e_hidden_dim, mc.xi_hidden_dim
    epack = torch.cat([randn(b, n * n, se), randn(b, n * n, 3 * ve, scale=0.5),
                       randn(b, n * n, 9, scale=0.5), em], dim=-1) * em
    s_node = randn(b, n, mc.h_hidden_dim) * mask[..., None]
    v_node = randn(b, n, 3 * mc.chi_hidden_dim) * mask[..., None]
    return (s_node.to(dtype), v_node.to(dtype), epack.to(dtype).contiguous(), g1, chain), ve


def time_ms(torch, fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(torch, evd):
    from bio_diffusion_torch.ops import message_layer as ml

    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, n, padded in ((8, 19, False), (8, 29, False), (8, 19, True), (2, 64, False)):
            args, ve = kernel_inputs(torch, evd, b, n, dtype, padded, seed=b * 1000 + n)
            sk, vk = ml.fused_message_layer(*args, ve_dim=ve)
            sp, vp = ml.message_layer_plain(*args, ve_dim=ve)
            torch.cuda.synchronize()
            for part, k, p in (("s_agg", sk, sp), ("v_agg", vk, vp)):
                err = (k.float() - p.float()).abs().max().item()
                ref = p.float().abs().max().item()
                ok = err <= TOL_REL[name] * ref and bool(torch.isfinite(k).all())
                print(f"kernel-vs-plain {name} B={b} N={n} padded={padded} {part}: "
                      f"max_abs_err={err:.6g} max|plain|={ref:.6g} rel={err / ref:.3g} "
                      f"tol={TOL_REL[name]:g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"message-layer kernel disagrees with the plain version ({name}, N={n})")
                if name == "bfloat16" and (b, n, padded) == (8, 19, False):
                    result["max_abs_err"] = max(result.get("max_abs_err", 0.0), err)
                    result["max_rel_err"] = max(result.get("max_rel_err", 0.0), err / ref)
    for b in (8, 250):
        args, ve = kernel_inputs(torch, evd, b, 19, torch.bfloat16, False, seed=7)
        times = {}
        # plain, kernel, kernel, plain: both measured twice, in turns
        for label in ("plain", "kernel", "kernel", "plain"):
            fn = ml.message_layer_plain if label == "plain" else ml.fused_message_layer
            times.setdefault(label, []).append(time_ms(torch, lambda: fn(*args, ve_dim=ve)))
        kernel_ms, plain_ms = min(times["kernel"]), min(times["plain"])
        print(f"timing bf16 B={b} N=19: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(runs {times})")
        if b == 8:
            result["ms"], result["plain_ms"] = kernel_ms, plain_ms
    return result


def check_denoiser(torch):
    """Full-width denoiser, float32: the card (kernel) against the CPU (plain)."""
    import copy

    from bio_diffusion_torch.cli.serve import build_model
    from bio_diffusion_torch.ops.geometry import centralize

    exp = qm9_experiment("fp32")
    evd_gpu = build_model(exp, None, torch.device("cuda"), seed=1)
    evd_cpu = copy.deepcopy(evd_gpu).to("cpu")
    gen = torch.Generator().manual_seed(3)
    b, n = 2, 11
    mask = torch.ones(b, n)
    mask[1, 8:] = 0
    x = torch.randn(b, n, 3, generator=gen) * mask[..., None]
    _, x = centralize(x, mask)
    h = torch.randn(b, n, 6, generator=gen) * mask[..., None]
    xh = torch.cat([x, h], dim=-1)
    t = torch.full((b, 1), 0.5)
    with torch.inference_mode():
        out_cpu = evd_cpu.dynamics_network(xh, t, mask)
        out_gpu = evd_gpu.dynamics_network(xh.cuda(), t.cuda(), mask.cuda()).cpu()
    err = (out_gpu - out_cpu).abs().max().item()
    ref = out_cpu.abs().max().item()
    ok = bool(torch.isfinite(out_gpu).all()) and err <= TOL_DENOISER_REL * ref
    print(f"denoiser card-vs-cpu fp32 B={b} N={n}: max_abs_err={err:.6g} max|cpu|={ref:.6g} "
          f"tol={TOL_DENOISER_REL:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("full-width denoiser on the card disagrees with the CPU")


def check_molecules(mols, num_samples):
    import numpy as np

    if len(mols) != num_samples:
        raise AssertionError(f"{len(mols)} molecules for a request of {num_samples}")
    for mol in mols:
        pos = np.asarray(mol["positions"], dtype=np.float64)
        if pos.shape != (mol["size"], 3) or len(mol["atoms"]) != mol["size"]:
            raise AssertionError("molecule fields disagree on its size")
        if not np.isfinite(pos).all():
            raise AssertionError("non-finite positions")
        if np.abs(pos.mean(axis=0)).max() > 1e-3 * max(1.0, np.abs(pos).max()):
            raise AssertionError("positions are not CoM-free")
        if len(mol["charges"]) != mol["size"]:
            raise AssertionError("charges missing")


def drive_main_path(torch):
    from bio_diffusion_tpu.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.cli.serve import build_server
    from bio_diffusion_torch.ops import message_layer as ml

    cfg = load_config(default_config_dir(), "serve", [
        "ckpt_path=null", "seed=0", "serving_batch_size=8", "device=cuda", "precision=bf16",
    ])
    layers = int(cfg["model"]["model_cfg"]["num_encoder_layers"])
    ml.reset_launch_counts()
    server = build_server(cfg)
    try:
        t0 = time.perf_counter()
        server.warmup([20])
        torch.cuda.synchronize()
        print(f"warmup bucket 20: {time.perf_counter() - t0:.3f} s")
        T_full = int(server.sampler.evd.T)
        requests = [
            ("full-T", dict(num_samples=8, num_nodes=19), T_full),
            ("seeded-a", dict(num_samples=8, seed=1234, num_timesteps=50), 50),
            ("seeded-b", dict(num_samples=8, seed=1234, num_timesteps=50), 50),
            ("distribution", dict(num_samples=8, num_timesteps=50), 50),
        ]
        outs = {}
        for name, kwargs, steps in requests:
            launches0, batches0 = ml.launch_counts["message_layer"], server.stats["batches"]
            t0 = time.perf_counter()
            out = server.generate(timeout=900, **kwargs)
            sec = time.perf_counter() - t0
            launches = ml.launch_counts["message_layer"] - launches0
            batches = server.stats["batches"] - batches0
            need = layers * (steps + 1) * batches
            check_molecules(out["molecules"], kwargs["num_samples"])
            print(f"request {name}: {kwargs['num_samples']} molecules, T={steps}, {sec:.3f} s, "
                  f"{server.batch_size * steps * batches / sec:.1f} denoiser evals/s "
                  f"(batch x steps / s), batches={batches}, kernel launches={launches} "
                  f"(need >= {need}), mol_stable_frac={out['mol_stable_frac']:.3f}, "
                  f"sizes={[m['size'] for m in out['molecules']]}")
            if batches < 1 or launches < need:
                raise AssertionError(f"request {name}: the kernel was not launched for every layer call")
            outs[name] = out
        if outs["seeded-a"]["molecules"] != outs["seeded-b"]["molecules"]:
            raise AssertionError("two requests with the same seed returned different molecules")
        print("seeded pair identical: ok")
        launches = ml.launch_counts["message_layer"]
        print(f"server: {json.dumps(server.describe())}")
        check_decoded_batch(torch, server)
        return launches
    finally:
        server.close()


def check_decoded_batch(torch, server):
    """A padded batch through the server's sampler: padded rows 0, one type per
    real atom, integer charges, finite CoM-free positions."""
    import numpy as np

    from bio_diffusion_torch.train.sampling import make_node_mask

    sizes = [19, 17, 15, 12, 19, 9, 5, 18]
    mask = make_node_mask(sizes, 20)
    gen = torch.Generator(device="cuda").manual_seed(11)
    xh = server.sampler.run(mask, gen, num_timesteps=50)
    k = len(server.dataset_info["atom_decoder"])
    real = mask > 0
    if xh.shape != (8, 20, 3 + k + 1) or not np.isfinite(xh).all():
        raise AssertionError(f"decoded batch has shape {xh.shape} or non-finite values")
    if np.any(xh[~real] != 0):
        raise AssertionError("padded rows are not zero")
    one_hot = xh[..., 3: 3 + k]
    if not (np.all(one_hot[real].sum(-1) == 1) and np.all(np.isin(one_hot, (0.0, 1.0)))):
        raise AssertionError("a real atom does not have exactly one type")
    charges = xh[..., 3 + k]
    if not np.all(charges == np.round(charges)):
        raise AssertionError("charges are not integers")
    com = (xh[..., :3] * mask[..., None]).sum(1) / mask.sum(1)[:, None]
    if np.abs(com).max() > 1e-3 * max(1.0, np.abs(xh[..., :3]).max()):
        raise AssertionError("decoded positions are not CoM-free")
    print("decoded padded batch: finite, CoM-free, padded rows 0, one-hot, integer charges: ok")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    if not os.path.isdir(os.path.join(REPO, "bio_diffusion_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from bio_diffusion_torch.cli.serve import build_model
    from bio_diffusion_torch.ops import build

    t0 = time.perf_counter()
    build.load_library("message_layer")
    print(f"built message_layer in {time.perf_counter() - t0:.2f} s")
    for line in build.build_log.get("message_layer", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  nvcc: {line.strip()}")

    evd_kernels = build_model(qm9_experiment("bf16"), None, torch.device("cuda"), seed=0)
    kernel = check_kernel(torch, evd_kernels)
    del evd_kernels
    check_denoiser(torch)
    launches = drive_main_path(torch)

    print(json.dumps({"kernels": [{
        "name": "message_layer",
        "route": "cuda",
        "source": "bio_diffusion_torch/csrc/message_layer.cu",
        "replaces": "bio_diffusion_tpu/ops/pallas/gcp_kernel.py:619",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "max_rel_err": kernel["max_rel_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
