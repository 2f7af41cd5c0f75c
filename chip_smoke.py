#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one), prints the card's
   name and power limit, and turns TF32 off.
2. Builds the CUDA kernels from ``bio_diffusion_torch/csrc`` (nvcc, sm_90a,
   one compiler per source, started together) and prints each one's
   registers and spills, and the forward's and the chain kernel's shared
   memory per block and blocks per SM; for the backward's row kernel
   (float32, bfloat16) and weight-grad kernel also each one's registers and
   local memory a thread, shared memory per block and blocks per SM.
3. Holds the message-layer kernel against its plain PyTorch version at full
   QM9 width (S=256, V=32, Se=64, Ve=16, 4 message GCPs), in float32 and
   bfloat16, at B=8 with N=19 and N=29, on a padded batch and at N=64; then
   times both at B=8 and B=250 with N=19 and at B=16 with N=64, bfloat16.
4. Holds the message-layer backward kernel against its plain version (autograd
   through the plain forward) at full width, float32 and bfloat16, at B=8
   with N=19, B=8 with N=29 and padded rows, B=2 with N=64, and at the
   training path's B=64, N=29 with padded rows: every output (the node and
   edge cotangents and all 18 weight grads), two runs bit-identical.  At
   B=64, N=29 the forward kernel is held against its plain version too, and
   both pairs are timed on the same inputs, and the backward's three kernels
   (row kernel, node-side sums, weight grads with their split reduction
   folded in) are timed by name under ``torch.profiler``, each beside its
   own bound; the two after the row kernel also beside their library calls,
   the PyTorch calls that compute the same function on a scratch of the row
   kernel's layout (``torch.mm`` of each weight grad's column slices and
   ``sum(0)`` of each bias's, ``torch.sum`` of GCP1's cotangent columns over
   either node), timed before and after them; the folded reduction keeps
   its entry (no time of its own) with its bound and ``sum(0)`` of split
   partials.  Then the two reductions alone (their own C entries) on a
   seeded scratch of that shape against their plain twins, the weight
   grads' in-place write of a later chunk exact, the tile counters 0 after
   the calls.  The kernels line reports the backward's errors and times at
   B=64, N=29 (float32, bfloat16 beside) and its split by kernel.
5. Checks the full-width denoiser on the card (kernels) against the same
   weights on the CPU (plain versions), float32, on a small batch: the
   output, then the gradient of every parameter.
6. Drives the serving path: ``cli.serve.build_server`` on
   ``configs/serve.yaml`` (bf16, weights drawn from seed 0, batch 8), one
   warmed bucket, then requests through ``MoleculeServer.generate``: 8
   molecules at the model's T=1000, a seeded pair at T=50 that must match
   exactly, and a distribution-sized request at T=50.  The kernel's launch
   count must show 9 launches per denoiser call of every executed batch.
   Then decodes a padded batch through the server's sampler and checks the
   molecules: finite, CoM-free, padded rows 0, one type per real atom,
   integer charges.  Last, times 20 reverse steps of the server's model at
   the reference workload's B=250, N=19 (CUDA events) and prints the share
   of the step that the kernel's 9 launches take.
7. Drives the training path: ``cli.train.main`` on ``configs/train.yaml``
   with ``experiment=qm9_mol_gen_ddpm`` at full width on the synthetic
   QM9-schema data (B=64, N=29, weights drawn from the seed): 10 optimizer
   steps in float32 with validation on the EMA weights after each epoch, then
   3 steps in bfloat16.  The loss must be finite, the parameters and the EMA
   must have moved, and the counts must show exactly 9 forward and 9
   backward launches per training micro-batch (and 2 x 9 forward launches
   per validation batch).  Times 6 (float32) and 4 (bfloat16) further
   Trainer steps with CUDA events and prints the peak device memory.
8. Drives the user path from files on disk to evaluated samples, fp32 at
   full width: writes QM9-layout files (1,024/256/256 molecules with
   hydrogens, N=29, from a seed) under ``outputs/user_path``; runs
   ``cli.train.main`` on them (batch 64, 4 train batches, 2 EMA validation
   batches, a sampling evaluation of 16 molecules at T=1000); restores the
   checkpoint into zeroed copies and requires every tensor bit-identical to
   the trainer's; runs ``cli.train.main`` again, which must resume at the
   saved step and train on; then ``cli.mol_gen_sample.main`` (64 molecules,
   sizes drawn, T=1000; 64 xyz files whose molecules pass the checks of the
   serving phase) and ``cli.mol_gen_eval.main`` (64 molecules, one NLL pass
   over the test split; a finite ``test_nll``) from the checkpoint
   directory.  Every run's forward and backward launch counts must be
   exact; prints seconds per reverse step, molecules per second and the
   Trainer's ms/step on those files.
9. Drives the conditional path, fp32 at full width, on the user path's
   QM9-layout files: ``cli.train.main`` with
   ``experiment=qm9_mol_gen_conditional_ddpm`` (alpha, no charge channel,
   ``QM9_second_half``; batch 64, 4 train batches, 2 EMA validation batches,
   a sampling evaluation of 16 molecules at T=1000 with drawn contexts);
   ``cli.train_classifier.main`` (alpha, hidden 128, 7 layers, batch 96, one
   epoch on ``QM9_first_half``); ``cli.mol_gen_eval_conditional_qm9.main``
   with that checkpoint and classifier (one iteration of 100 molecules at
   T=1000); ``cli.mol_gen_eval_optimization_qm9.main`` (100 starting
   molecules from seed weights in 10 steps, then 2 round trips of 100 steps
   through the conditional model).  Every path's launch counts are held
   exactly (none for the classifier); prints the phase's seconds, the
   conditional sampler's seconds per reverse step and molecules per second,
   and the MAE and stability (not judged).
10. Holds the flat-edge GCP2 chain kernel against its plain version at full
   QM9 width (G=3, S=256, V=32, H=8, the weights of layer 0 of the bf16
   model), float32 and bfloat16, at E=53,824 (B=64, N=29), E=90,250 (B=250,
   N=19) and a ragged E, then times both at the first two sizes.
11. Drives the unfused message-passing path
   (``models.gcpnet.message_passing_unfused``, which runs that kernel)
   against the fused message-layer kernel on the same layer inputs and
   weights at B=64, N=29 (float32 and bfloat16, both timed); the chain
   kernel must have been launched in this phase.
12. Holds the pass-probe kernel against its plain version for each of its
   nine ops at k=8, then runs the probe (``cli.bench_passes``) at its
   default shape: each op at k=1, 8, 104 and 208 beside its plain version
   and its one PyTorch call, its bound from its SASS counts (``PASS_SASS``,
   read again from the built library where ``cuobjdump`` is found: a count
   that differs fails the run) and the SM clock while it times.
13. Drives the GEOM-Drugs path (after the conditional path), fp32 at the
   published ``geom_mol_gen_ddpm`` width (4 layers, S=256, V=32, Se=16,
   Ve=8, batch 64 in the buckets [48, 64, 96, 128, 192]): writes GEOM-layout
   files (1,280 conformers, sizes from GEOM-Drugs' histogram, from a seed)
   under ``outputs/geom_path``; holds both message-layer kernels against
   their plain versions at GEOM width (float32 and bfloat16; forward at
   B=8/N=48, B=4/N=96 and B=2/N=181 with padded rows, backward at the last
   two), times the forward at B=16, N=96 and the backward at B=4, N=96
   beside their plain versions; holds the backward walked in 4 chunks of
   molecules against one call at B=16, N=96, holds the backward's two
   reductions alone against their plain twins at the plan's largest chunk
   (4 molecules at N=192), and times one backward at B=64,
   N=96 in the wrapper's own chunks with its peak memory; runs 2 Trainer
   steps on the worst batch the config admits (B=64 padded to 192, a
   181-atom molecule: finite loss, 4 + 4 launches, ms and peak memory
   against the card's); then ``cli.train.main`` (4 train batches in their
   buckets, 2 EMA validation batches, a sampling evaluation of 16 at
   T=1000), ``cli.mol_gen_sample.main`` and ``cli.mol_gen_eval.main`` (16
   molecules each, one NLL pass over the 2 test batches) from the
   checkpoint directory, every launch count exact; prints each sampler
   batch's padded N, seconds per reverse step and molecules per second.
14. Drives the pocket path (after the GEOM path), fp32 at the
   ``pocket_mol_gen_ddpm`` width (the GEOM widths; 30 atom types = 10
   ligand + 20 residue, no charge channel; batch 32 in the buckets [48, 64,
   96, 128, 144]), weights drawn from a seed: holds B1 against its plain
   version at the training shape B=32, N=144 (padded rows; timed in
   turns), B2 against its plain version at B=2, N=144, and B2 at B=32,
   N=144 in the wrapper's 4 chunks of 8 against one whole-batch call
   (per-molecule outputs bit-identical; timed, with its peak memory); then
   (a) ``cli.train.main`` on the synthetic joint graphs (4 train batches,
   2 EMA validation batches; each batch's bucket, B2's launches by batch
   held against the plan of 1 / 1 / 2 / 4 / 4 chunks in the 48 / 64 / 96 /
   128 / 144 buckets, peak memory) and 2 more Trainer steps on the 32
   largest train graphs (CUDA events, launches, peak memory), (b)
   ``cli.mol_gen_sample.main`` with
   ``ddpm_mode=pocket`` from (a)'s checkpoint into 8 synthetic pockets at
   T=1000 (4 x 1,001 launches; finite ligands, one ligand type a real
   atom, the pocket rows of ``joint_xh`` the input's bit for bit,
   ``pockets.json``; s per reverse step and the padded N), (c) the same
   into the binding site of a PDB file it writes (40 CAs of chain A around
   a HETATM ligand, a chain-B residue and an alternate location left out;
   T=100, 2 resamplings, jumps of 10: 4 x 191 launches), (d) the QM9
   ``inpainting`` mode (8 molecules of 19 atoms, the first fixed at the
   origin, T=1000: 9 x 1,001 launches).
15. Drives the chain mode (after the pocket path): ``cli.mol_gen_sample.main
   ddpm_mode=chain`` at full QM9 width, fp32, seed weights, one molecule of
   19 atoms, T=1000, ``keep_frames=100``: 9 x 1,001 launches, 110 frame
   files, the kept states finite, CoM-free and 0 on padded rows (none at
   N=19); prints seconds per reverse step at B=1 and whether a GIF was
   written (matplotlib and imageio may be absent).
16. Drives the property sweep: ``cli.mol_gen_eval_conditional_qm9.main
   task=qualitative`` on the conditional path's model and files, one sweep
   of 100 molecules of 19 atoms at T=1000 (9 x 1,001 launches, 100 xyz
   files); then its sampler at T=50 on contexts [c0, c0, c1, c1] with one
   noise draw: equal contexts give bit-identical molecules, different ones
   different molecules.
17. Drives ``cli.bench_serve`` in this process at full width, bf16: QM9 at
   a fixed size (batch 250, N=19, 100 steps, 4 requests, 2 clients), the
   QM9 size mix (batch 32, 100 steps, 8 requests of 32, 4 clients) and
   GEOM-Drugs serving (``SERVE_EXPERIMENT=geom_mol_gen_ddpm``, batch 8,
   sizes drawn, buckets up to 181 all warmed, 50 steps, 4 requests of 8);
   prints each JSON result; the launch count must be 9 (QM9) or 4 (GEOM) a
   denoiser call of every executed batch and warm-up; every request's
   molecules pass the serving checks (GEOM's without charges).
18. Drives the debug and profile switches of ``cli.train.main`` at full
   QM9 width, fp32, synthetic data: 2 steps with
   ``trainer.detect_anomaly=true`` (exact launch counts), a step on a batch
   with a corrupted padded row that must raise the masked-input check, 2
   steps with ``--profile`` and ``--dump-graph`` (the trace names the
   forward and backward row kernels; ``exec_time.log`` and
   ``graph/dynamics.ops.txt`` written); prints the ms of further steps with
   the checks on and off, in 8 turns of 6 further steps of the debug trainer.
19. Drives data parallelism (right after the user path, on its QM9-layout
   files), full QM9 width: (a) two ranks in two spawned processes on one
   card (gloo over CUDA tensors: NCCL refuses two ranks on one GPU), the
   Trainer's 3 float32 steps on global batches of 64 (N=29,
   32 rows a rank), held against one process taking the same 3 steps on
   the whole batches from the same seed: loss and grad norm per step to
   1e-4 relative, the parameters within 2 lr a step (median far below);
   rank 1 draws its initial weights from another seed and must end with
   rank 0's parameters bit for bit (the broadcast after ``init_state``);
   each rank's forward and backward launches read around its steps (27 and
   27) and its all-reduce timed around each call (two ranks share one
   card: no scaling figure); (b) ``cli.train`` under ``python -m
   torch.distributed.run --standalone --nproc_per_node=1`` (NCCL at world
   1; also 2 ranks where the machine has two cards): 2 steps, one EMA
   validation batch, exact launch counts, one checkpoint; (c) the sampler
   over ``[cuda:0, cuda:0]`` (and ``[cuda:0, cuda:1]`` on two cards), B=65
   (ragged across two), N=19, bf16, T=50, against the one-device sampler
   with the same seed (positions within 1e-2 of max|x|, every atom type
   equal), 9 launches a replica a step; a planted fault (two molecules'
   draws swapped across the replicas) must read above that limit.  Every
   rank is joined within a timeout; any failure
   fails the run.
20. Drives self-conditioning and the learned noise schedule (right after
   data parallelism, on the user path's QM9-layout files), fp32 at full
   QM9 width with ``self_condition=true noise_schedule=learned
   loss_type=vlb``: the denoiser with a nonzero self-conditioning input and
   its parameter gradients, card against CPU; ``cli.train.main`` (B=64, 4
   train batches, 2 EMA validation batches), each step's forward launches
   read around it and held at 9, or 18 where that step's draws run the
   self-conditioning pass, 9 backward a step, a finite loss and the
   schedule's endpoints moved from -5 and 10; ``cli.mol_gen_sample.main``
   from its checkpoint, 64 molecules at T=1000 in exactly 9 x (2 x 1000 +
   1) = 18,009 launches, the decoded batch (positions finite, padded rows
   0, one type a real atom) and the xyz files checked; prints ms per step
   and s per reverse step.
21. Drives the module-path denoisers (right after self-conditioning, on the
   user path's QM9-layout files), fp32 at full QM9 width, weights from the
   seed, in four configurations (``MODULE_PATHS``: GCP v1 with the frame
   gate; GCP norm, dropout 0.1, 2 feedforward GCPs and the vector-sum
   update; no frame updates and no attention; the EGNN denoiser): the
   denoiser card against CPU and its gradients against the CPU in float64;
   ``cli.train.main`` 3 steps at B=64 (finite losses, ms a step, peak
   memory, no B1 or B2 launch); ``cli.mol_gen_sample.main`` of 16 molecules
   at T=100 (a reduced depth; the molecules checked, s a reverse step, no
   launch); then the shipped configuration's Trainer with
   ``trainer.fast_train=off`` against ``auto`` (3 steps each on the same
   batches and draws: step 1's loss within 1e-4 relative, 0 and 9 + 9
   launches a step, ms a step of both).
22. Drives the tools (right after the module-path denoisers, on the user
   path's QM9-layout files), full QM9 width, each call's launches read
   around it: (a) ``cli.train.main`` fp32 B=64, 2 steps, with
   ``logger=many_loggers`` and ``extras.print_config=true``: the
   TensorBoard event file (read back by ``read_scalar_events``) and
   ``metrics.jsonl`` hold the steps and scalars of ``metrics.csv``, every
   batch came through the native collation (``data/native_loader.py``,
   built by g++ from ``csrc/xyz_parser.cc``), and each step's batch equals
   the numpy collation of the same molecules bit for bit; (b)
   ``cli.hparam_search`` with 2 random trials of 2 steps: ``study.json``
   holds 2 complete trials and a best one; (c)
   ``cli.generate_grid_search_runs`` on a 2-run space, then
   ``cli.generate_k8s_jobs`` on its manifest: the YAML parses and asks for
   ``nvidia.com/gpu`` under torchrun; (d) ``cli.bench_shape_sweep --cross
   --steps 20 --batches 32 250 --nodes 19 29`` (bf16): 9 launches a
   denoiser call of every run, evals/s, us a molecule-step and the fitted
   N exponent; (e) ``cli.bench_train_step --batch 64 --nodes 29 --precision
   fp32 --steps 3 --split``: the kernel path 9 + 9 launches a step, the
   module and plain paths none, their step-1 losses within 1e-5 relative,
   ms a step of each and the split; (f) ``cli.first_contact`` on a
   reference-layout ``.ckpt`` written from seed weights, 16 molecules at
   T=100: the import holds every parameter, every target metric has its
   tolerance, and the verdict is a fail (exit code 1), as seed weights
   must give; the seconds of each phase.

Prints one JSON line of per-kernel results (each with its bound: the larger
of its bytes over 3.35 TB/s and its operations over 989 TFLOP/s in bf16 or
67 TFLOP/s in float32), then, last, the device line.  Any failure raises and
the exit code is non-zero.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# tolerances of kernel vs plain version, relative to max|plain|: float32 with
# TF32 off differs only in summation order; bfloat16 rounds at other points
# than the plain version (which rounds after every op), ~1 bf16 ulp of 2^-8
TOL_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# backward kernel vs plain, relative to max|plain| of each output: float32
# differs in summation order only (sums over up to ~54k rows); in bfloat16 the
# plain version rounds every intermediate cotangent to bf16, the kernel
# accumulates in f32
TOL_BWD_REL = {"float32": 1e-4, "bfloat16": 5e-2}
# the unfused path against the fused kernel, relative to max|fused|: float32
# differs in summation order only; in bfloat16 the unfused path rounds after
# every PyTorch op (its first GCP adds six rounded terms where the kernel sums
# in f32), as the plain version does, so it gets the plain version's tolerance
TOL_UNFUSED_REL = dict(TOL_REL)
# the backward's reductions alone against their plain twins (torch.sum,
# torch.mm), relative to max|twin| of each output: float32, summation order
# only (the kernels add in index order from 0.f over up to 147,456 rows)
TOL_SUMS_REL = 1e-4
# the pass probe against its plain version, relative to max(1, max|plain|)
# over the finite values (float32; only the sigmoid and silu forms and the
# rsqrt approximation differ)
TOL_PASSES_REL = 1e-5
# the card's peaks (NVIDIA H100 SXM data sheet): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the rate
# of their type (bf16 tensor cores; float32 FMA, an FMA counted as 2)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 67e12}
# full-width denoiser, card vs CPU, float32, relative to max|CPU output|
TOL_DENOISER_REL = 1e-3
# its parameter gradients, card vs CPU, float32: relative to max|CPU grad| of
# each parameter, with a floor of 1e-6 of the largest gradient of all
TOL_GRAD_REL = 1e-3
# the module-path denoisers (no kernel on their path), full QM9 width: the
# overrides of each configuration the phase drives
MODULE_PATHS = {
    "v1": ("model.module_cfg.selected_gcp=gcp", "model.module_cfg.frame_gate=true"),
    "regularized": ("model.layer_cfg.use_gcp_norm=true", "model.layer_cfg.use_gcp_dropout=true",
                    "model.model_cfg.dropout=0.1", "model.layer_cfg.num_feedforward_layers=2",
                    "model.module_cfg.update_positions_with_vector_sum=true"),
    "ablated": ("model.module_cfg.ablate_frame_updates=true", "model.layer_cfg.use_scalar_message_attention=false"),
    "egnn": ("model.diffusion_cfg.dynamics_network=egnn",),
}
# their denoisers card vs CPU, float32 (cuBLAS against the CPU's products,
# summation order only): the output relative to max|CPU output|; each
# parameter's gradient against the CPU's in float64, relative to its
# max|grad| (floor 1e-6 of the largest gradient of all), or, where the
# CPU's own float32 gradient is farther than that from float64 (a sum of
# terms that cancel: up to 2.5e-4 relative in EGNN's deeper coordinate
# MLPs), within twice the CPU's float32 error
TOL_MODULE_DENOISER_REL = 1e-5
TOL_MODULE_GRAD_REL = 1e-4
# a fast_train=off step against the packed forward's on the same batch and
# draws, float32: the loss relative
TOL_FAST_OFF_REL = 1e-4
# the reduced depth of the module-path sampling runs
MODULE_SAMPLE_T = 100
# the tools phase: the train-step benchmark's step-1 losses of its three
# paths from the same weights and draws, float32, relative
TOL_TOOLS_LOSS_REL = 1e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def bound(flops: float, moved: float, dtype_name: str):
    """(bound_ms, bound_by): the least time for ``flops`` operations of the
    given type and ``moved`` bytes, each moved once."""
    t_ops, t_bytes = flops / PEAK_FLOP_S[dtype_name], moved / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    """Bytes of a nest of tensors (dicts, lists, tuples), each counted once."""
    out = 0
    for t in tensors:
        if isinstance(t, dict):
            out += nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            out += nbytes(*t)
        else:
            out += t.numel() * t.element_size()
    return out


def qm9_experiment(precision: str, extra=()):
    from bio_diffusion_torch.config.build import build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config

    cfg = load_config(default_config_dir(), "serve", [f"trainer.precision={precision}", *extra])
    return build_experiment(cfg)


def kernel_inputs(torch, evd, b, n, dtype, padded, seed):
    """Layer-0 packed weights of the full-width model and seeded random
    node/edge inputs, on the card."""
    from bio_diffusion_torch.ops.message_layer import detached, pack_message_stack

    mc = evd.dynamics_network.model_cfg
    mp = evd.dynamics_network.interaction_layers[0].interaction
    g1, chain = detached(pack_message_stack(mp, mc.h_hidden_dim, mc.chi_hidden_dim,
                                            mc.xi_hidden_dim, dtype))
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


def layer_flops(args, ve) -> float:
    """FLOPs of one forward message-layer call: the per-edge-row products
    (``layer_macs_per_row``) and the node-side projections, 2 per multiply-add."""
    from bio_diffusion_torch.ops.message_layer import layer_macs_per_row

    s_node, v_node, _, g1, chain = args
    b, n, s_dim = s_node.shape
    v_dim = v_node.shape[-1] // 3
    h1 = g1["wu_bd"].shape[0] // 3
    se = g1["wsx"].shape[0] - h1 - 9
    hc = (chain[0].shape[2] - 27) // 3
    rows = layer_macs_per_row(s_dim, v_dim, se, ve, h1, hc, chain[0].shape[0])
    node = 2 * (s_dim * s_dim + 3 * v_dim * (3 * h1 + 27))
    return 2.0 * (b * n * n * rows + b * n * node)


def bwd_sub_bounds(args, ct, ve, name):
    """{kernel: (bound_ms, bound_by)} of the backward's kernels on these
    inputs.  ``bwd_rows_kernel``: the recompute's and the input cotangents'
    products per edge row (in bfloat16 the recompute's four wide products at
    the bf16 rate: they run on the tensor cores), and the bytes of the layer's
    inputs, cotangents and d_epack.  ``weight_grad_kernel``: one multiply-add
    per edge row and weight-grad element, and the bytes of the scratch columns
    it reads (each once) and of the grads.  ``proj_sum_kernel``: the bytes of
    the columns it sums and of its outputs.  ``reduce_kernel`` (folded into
    ``weight_grad_kernel``, kept for the record): the bytes of the split
    partials (one a chunk of rows and grad element) and of the grads."""
    from bio_diffusion_torch.ops import message_layer as ml

    s_node, v_node, epack, g1, chain = args
    b, n, s_dim = s_node.shape
    v_dim = v_node.shape[-1] // 3
    h1 = g1["wu_bd"].shape[0] // 3
    se = g1["wsx"].shape[0] - h1 - 9
    num_gcps, hc = chain[0].shape[0], (chain[0].shape[2] - 27) // 3
    rows = b * n * n
    w1, wc, m1, v3 = 3 * h1 + 27, 3 * hc + 27, s_dim + hc + 9, 3 * v_dim
    fwd = ml.layer_macs_per_row(s_dim, v_dim, se, ve, h1, hc, num_gcps) - s_dim
    wide = (se + h1 + 9) * s_dim + s_dim * v_dim + num_gcps * (m1 * s_dim + s_dim * v_dim)
    fast = wide if name == "bfloat16" else 0
    t_ops = 2.0 * rows * (fast / PEAK_FLOP_S["bfloat16"] + (2 * fwd - fast) / PEAK_FLOP_S["float32"])
    t_bytes = (nbytes(args, ct) + nbytes(epack)) / PEAK_BYTES_S
    out = {"bwd_rows_kernel": (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")}
    grads = sum(g1[k].numel() for k in ("wve", "wsx", "bs", "wu_bd", "wg", "bg")) + sum(c.numel() for c in chain)
    cols = (3 * ve + se + h1 + 9 + s_dim + w1 + s_dim + v3 + v_dim + 3 * h1
            + num_gcps * (v3 + m1 + s_dim + wc + s_dim + v3 + v_dim + 3 * hc) + s_dim + 1)
    out["weight_grad_kernel"] = bound(2.0 * rows * grads, 4.0 * (rows * cols + grads), "float32")
    out["proj_sum_kernel"] = bound(rows * (s_dim + w1), 4.0 * (rows + 2 * b * n) * (s_dim + w1), "float32")
    splits = bwd_splits(rows)
    out["reduce_kernel"] = bound(splits * grads, 4.0 * (splits + 1) * grads, "float32")
    return out


def bwd_splits(rows):
    """Row chunks of the backward's weight grads (``splits_for`` in
    ``csrc/message_layer_bwd.cu``): about 2,048 rows each, at most 32."""
    return min(32, max(1, -(-rows // 2048)))


def bwd_library_calls(torch, args, ve):
    """One PyTorch call a product for each of the backward's functions after
    the row kernel, on a scratch of the row kernel's layout at these inputs'
    shape (values from a seed; no call's time depends on them):
    ``weight_grad_kernel`` -> ``torch.mm`` of each weight grad's column
    slices (X^T dY) and ``Tensor.sum(0)`` of each bias's; ``proj_sum_kernel``
    -> ``torch.sum`` of GCP1's cotangent columns over the target and over
    the source node; ``reduce_kernel`` (now inside ``weight_grad_kernel``)
    -> ``Tensor.sum(0)`` of split partials, one a chunk of rows and grad
    element -> {kernel: fn}."""
    from bio_diffusion_torch.ops import message_layer as ml

    s_node, _, _, g1, chain = args
    b, n, _ = s_node.shape
    widths = ml.bwd_widths(g1, chain, ve)
    rl = ml.bwd_row_layout(*widths)
    rows_n = b * n * n
    sizes = ml._bwd_workspace(ml._bwd_library(), ml._bwd_dims(b, n, widths))
    if sizes[0] != rows_n * rl["width"]:
        raise AssertionError(f"the scratch layout copy disagrees with the kernel's ({sizes[0]} floats)")
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = torch.randn((rows_n, rl["width"]), generator=gen, device="cuda")
    grads = sum(g1[k].numel() for k in ("wve", "wsx", "bs", "wu_bd", "wg", "bg")) + sum(c.numel() for c in chain)
    partials = torch.randn((bwd_splits(rows_n), grads), generator=gen, device="cuda")
    products = ml.bwd_weight_grad_products(widths)

    def weight_grads():
        for _, bias, _, xo, k, yo, nn in products:
            torch.mm(rows[:, xo: xo + k].t(), rows[:, yo: yo + nn])
            if bias is not None:
                rows[:, yo: yo + nn].sum(0)

    w1 = 3 * widths[4] + 27
    edge = rows.view(b, n, n, rl["width"])[..., rl["dvhd1"]: rl["dvhd1"] + w1 + widths[0]]

    def proj_sums():
        edge.sum(2)
        edge.sum(1)

    return {"weight_grad_kernel": weight_grads, "proj_sum_kernel": proj_sums,
            "reduce_kernel": lambda: partials.sum(0)}


def check_bwd_reductions(torch, args, ve, label):
    """The backward's two reductions alone, each on a scratch of the row
    kernel's layout drawn from a seed at these inputs' shape, against its
    plain twin (``ops/message_layer.py``): ``proj_sum_kernel`` (both node
    sums) against ``torch.sum`` over either node, ``weight_grad_kernel``
    (with its folded split reduction) against ``torch.mm`` of the column
    slices and the bias ``sum(0)``; each output within TOL_SUMS_REL of
    max|twin| (float32, summation order only: the kernels add in index order
    from 0.f, PyTorch in its own).  The weight grads again with ``out=``:
    exactly twice the first (the in-place final write of a later chunk); the
    tile counters all 0 after the calls -> each one's worst relative error."""
    from bio_diffusion_torch.ops import message_layer as ml

    s_node, _, _, g1, chain = args
    b, n, _ = s_node.shape
    widths = ml.bwd_widths(g1, chain, ve)
    width = ml.bwd_row_layout(*widths)["width"]
    gen = torch.Generator(device="cuda").manual_seed(b * 1000 + n)
    rows = torch.randn((b * n * n, width), generator=gen, device="cuda")
    out = {}
    pairs = {
        "proj_sum_kernel": (lambda: ml.bwd_proj_sums(rows, b, n, widths),
                            lambda: ml.bwd_proj_sums_plain(rows, b, n, widths)),
        "weight_grad_kernel": (lambda: ml.bwd_weight_grads(rows, b, n, widths),
                               lambda: ml.bwd_weight_grads_plain(rows, widths)),
    }
    for name, (kernel_fn, twin_fn) in pairs.items():
        got, want = kernel_fn(), twin_fn()
        torch.cuda.synchronize()
        worst = 0.0
        for k, (a, w) in enumerate(zip(got, want)):
            ref = w.abs().max().item()
            rel = (a - w).abs().max().item() / ref if ref > 0 else 0.0
            if a.shape != w.shape or not bool(torch.isfinite(a).all()) or rel > TOL_SUMS_REL:
                raise AssertionError(f"{name} alone ({label}) disagrees with its twin in output {k}: {rel:.3g}")
            worst = max(worst, rel)
        if name == "weight_grad_kernel":
            twice = ml.bwd_weight_grads(rows, b, n, widths, out=[t.clone() for t in got])
            torch.cuda.synchronize()
            if not all(torch.equal(t, 2 * g) for t, g in zip(twice, got)):
                raise AssertionError(f"weight_grad_kernel ({label}): the accumulating write is not exact")
        out[name] = dict(max_rel_err=worst)
        print(f"{name} alone vs its twin {label}: max rel err {worst:.3g} (tol {TOL_SUMS_REL:g}): ok")
    torch.cuda.synchronize()
    dirty = [k for k, t in ml._bwd_tickets.items() if bool(t.any())]
    if dirty:
        raise AssertionError(f"weight-grad tile counters left non-zero on {dirty}")
    out["tile_counters_zero"] = True
    del rows
    return out


def device_ms_per_call(torch, fn, reps):
    """Device ms per call of ``fn`` (every kernel it launches, summed) over
    ``reps`` calls under ``torch.profiler``, after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    from bio_diffusion_torch.cli.profile_train import device_times

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(v[0] for v in device_times(prof.events(), reps).values())


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

def in_turns(torch, kernel_fn, plain_fn, reps):
    """plain, kernel, kernel, plain: both timed twice, in turns -> (best kernel
    ms, best plain ms, all runs)."""
    times = {}
    for label in ("plain", "kernel", "kernel", "plain"):
        times.setdefault(label, []).append(time_ms(torch, kernel_fn if label == "kernel" else plain_fn, reps))
    return min(times["kernel"]), min(times["plain"]), times


def compare_fwd(torch, args, ve, name, label):
    """Forward kernel against its plain version on the same inputs, both
    outputs within TOL_REL[name] of max|plain| -> (max abs error, max relative
    error)."""
    from bio_diffusion_torch.ops import message_layer as ml

    sk, vk = ml.fused_message_layer(*args, ve_dim=ve)
    sp, vp = ml.message_layer_plain(*args, ve_dim=ve)
    torch.cuda.synchronize()
    worst_abs, worst_rel = 0.0, 0.0
    for part, k, p in (("s_agg", sk, sp), ("v_agg", vk, vp)):
        err = (k.float() - p.float()).abs().max().item()
        ref = p.float().abs().max().item()
        ok = err <= TOL_REL[name] * ref and bool(torch.isfinite(k).all())
        print(f"kernel-vs-plain {name} {label} {part}: max_abs_err={err:.6g} max|plain|={ref:.6g} "
              f"rel={err / ref:.3g} tol={TOL_REL[name]:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"message-layer kernel disagrees with the plain version ({name}, {label})")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / ref)
    return worst_abs, worst_rel


def check_kernel(torch, evd):
    from bio_diffusion_torch.ops import message_layer as ml

    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, n, padded in ((8, 19, False), (8, 29, False), (8, 19, True), (2, 64, False)):
            args, ve = kernel_inputs(torch, evd, b, n, dtype, padded, seed=b * 1000 + n)
            err, rel = compare_fwd(torch, args, ve, name, f"B={b} N={n} padded={padded}")
            if name == "bfloat16" and (b, n, padded) == (8, 19, False):
                result["max_abs_err"], result["max_rel_err"] = err, rel
    # the serving shapes, and N=64: target rows in two tiles, the case of the
    # TPU kernel's sub-molecule body (n * n > 2600 there)
    result["by_shape"] = {}
    for b, n in ((8, 19), (250, 19), (16, 64)):
        args, ve = kernel_inputs(torch, evd, b, n, torch.bfloat16, False, seed=7)
        kernel_ms, plain_ms, runs = in_turns(torch, lambda: ml.fused_message_layer(*args, ve_dim=ve),
                                             lambda: ml.message_layer_plain(*args, ve_dim=ve), reps=20)
        out = ml.fused_message_layer(*args, ve_dim=ve)
        bound_ms, bound_by = bound(layer_flops(args, ve), nbytes(args, out), "bfloat16")
        print(f"timing bf16 B={b} N={n}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}) (runs {runs})")
        result["by_shape"][f"bf16, B={b}, N={n}"] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                                          bound_by=bound_by)
    result.update(result["by_shape"]["bf16, B=8, N=19"])
    return result


def kernel_occupancy(torch, evd):
    """Dynamic shared memory per block and blocks per SM of the forward kernel
    (B1, at the dataset's largest molecule) and the chain kernel (B3) at full
    width, as their launches set them up -> {name: {dtype: (bytes, blocks)}}."""
    import ctypes

    from bio_diffusion_torch.ops import build

    mc = evd.dynamics_network.model_cfg
    (_, _, _, g1, chain), ve = kernel_inputs(torch, evd, 1, 2, torch.bfloat16, False, seed=0)
    s_dim, v_dim, se = mc.h_hidden_dim, mc.chi_hidden_dim, mc.e_hidden_dim
    h1, hc = g1["wu_bd"].shape[0] // 3, (chain[0].shape[2] - 27) // 3
    ml_lib, chain_lib = build.load_libraries("message_layer", "gcp2_chain")
    for fn, nargs in ((ml_lib.message_layer_smem_bytes, 7), (chain_lib.gcp2_chain_smem_bytes, 3),
                      (ml_lib.message_layer_blocks_per_sm, 2), (chain_lib.gcp2_chain_blocks_per_sm, 2)):
        fn.argtypes, fn.restype = [ctypes.c_int] * nargs, ctypes.c_int
    n_max = 29  # QM9's largest molecule
    smem = {"message_layer": ml_lib.message_layer_smem_bytes(s_dim, v_dim, se, ve, h1, hc, n_max),
            "gcp2_chain": chain_lib.gcp2_chain_smem_bytes(s_dim, v_dim, hc)}
    per_sm = {"message_layer": ml_lib.message_layer_blocks_per_sm,
              "gcp2_chain": chain_lib.gcp2_chain_blocks_per_sm}
    out = {}
    for name, fn in per_sm.items():
        for bf16, dt in ((0, "float32"), (1, "bfloat16")):
            blocks = fn(bf16, smem[name])
            print(f"  occupancy {name} {dt}: {smem[name]} B of dynamic shared memory per block, "
                  f"{blocks} blocks per SM")
            if blocks < 1:
                raise AssertionError(f"{name} ({dt}) fits no block on an SM (code {blocks})")
            out.setdefault(name, {})[dt] = (smem[name], blocks)
    return out


def bwd_occupancy(torch, evd):
    """Registers and local memory a thread (spills and stack, as loaded),
    shared memory per block and blocks per SM of the backward's row kernel
    (float32, bfloat16) and weight-grad kernel at full width, as their
    launches set them up."""
    import ctypes

    from bio_diffusion_torch.ops import message_layer as ml

    (_, _, _, g1, chain), ve = kernel_inputs(torch, evd, 1, 2, torch.bfloat16, False, seed=0)
    lib = ml._bwd_library()
    lib.message_layer_bwd_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    lib.message_layer_bwd_blocks_per_sm.restype = ctypes.c_int
    lib.message_layer_bwd_kernel_attrs.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.message_layer_bwd_kernel_attrs.restype = ctypes.c_int
    sizes = ml._bwd_workspace(lib, ml._bwd_dims(1, 2, ml.bwd_widths(g1, chain, ve)))
    kernels = {"bwd_rows_kernel float32": (0, 0), "bwd_rows_kernel bfloat16": (0, 1), "weight_grad_kernel": (1, 0)}
    out = {}
    for label, (kernel, bf16) in kernels.items():
        attrs = (ctypes.c_int * 3)()
        if lib.message_layer_bwd_kernel_attrs(kernel, bf16, ctypes.addressof(attrs)) != 0:
            raise AssertionError(f"{label}: no kernel attributes")
        # the row kernel's shared memory is dynamic (the workspace query), the weight-grad kernel's static
        smem = int(sizes[2]) if kernel == 0 else attrs[2]
        blocks = lib.message_layer_bwd_blocks_per_sm(kernel, bf16, smem if kernel == 0 else 0)
        if blocks < 1:
            raise AssertionError(f"{label} fits no block on an SM (code {blocks})")
        print(f"  occupancy {label}: {smem} B of {'dynamic' if kernel == 0 else 'static'} shared memory "
              f"per block, {blocks} blocks per SM, {attrs[0]} registers and {attrs[1]} B of local memory "
              f"(spills, stack) a thread")
        out[label] = dict(smem_bytes=smem, blocks_per_sm=blocks, registers=attrs[0], local_bytes=attrs[1])
    return out


def denoiser_inputs(torch, seed, t_value, self_condition=False):
    """A small seeded batch (B=2, N=11, molecule 1 with 3 padded rows): xh,
    t, mask and, for a self-conditioned model, a nonzero estimate (its
    keyword argument), on the CPU."""
    from bio_diffusion_torch.ops.geometry import centralize

    gen = torch.Generator().manual_seed(seed)
    b, n = 2, 11
    mask = torch.ones(b, n)
    mask[1, 8:] = 0
    x = torch.randn(b, n, 3, generator=gen) * mask[..., None]
    _, x = centralize(x, mask)
    h = torch.randn(b, n, 6, generator=gen) * mask[..., None]
    xh = torch.cat([x, h], dim=-1)
    sc = {"xh_self_cond": torch.randn(b, n, 9, generator=gen) * mask[..., None]} if self_condition else {}
    return xh, torch.full((b, 1), t_value), mask, sc, gen


def check_denoiser(torch, extra=(), label="fp32", tol=TOL_DENOISER_REL):
    """Full-width denoiser, float32: the card (kernel) against the CPU
    (plain); ``extra``: config overrides (a self-conditioned model gets a
    nonzero estimate); ``tol``: relative to max|CPU output| -> max abs error."""
    import copy

    from bio_diffusion_torch.cli.common import load_model

    exp = qm9_experiment("fp32", extra)
    evd_gpu = load_model(exp, None, torch.device("cuda"), seed=1)
    evd_cpu = copy.deepcopy(evd_gpu).to("cpu")
    xh, t, mask, sc, _ = denoiser_inputs(torch, 3, 0.5, exp.diffusion_cfg.self_condition)
    b, n = mask.shape
    with torch.inference_mode():
        out_cpu = evd_cpu.dynamics_network(xh, t, mask, **sc)
        out_gpu = evd_gpu.dynamics_network(xh.cuda(), t.cuda(), mask.cuda(),
                                           **{k: v.cuda() for k, v in sc.items()}).cpu()
    err = (out_gpu - out_cpu).abs().max().item()
    ref = out_cpu.abs().max().item()
    ok = bool(torch.isfinite(out_gpu).all()) and err <= tol * ref
    print(f"denoiser card-vs-cpu {label} B={b} N={n}: max_abs_err={err:.6g} max|cpu|={ref:.6g} "
          f"tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"full-width denoiser ({label}) on the card disagrees with the CPU")
    return err


def cotangents(torch, args, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    s, v = args[0], args[1]
    return (torch.randn(s.shape, generator=gen, device="cuda").to(s.dtype),
            torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype))


def compare_bwd(torch, args, ct, ve, name, label):
    """Backward kernel, run twice, against its plain version on the same
    inputs: the two runs bit-identical, each of the 21 outputs within
    TOL_BWD_REL[name] of max|plain| -> (max abs error, max relative error)."""
    from bio_diffusion_torch.ops import message_layer as ml

    first = ml.bwd_outputs(ml.fused_message_layer_bwd(*args, ct, ve_dim=ve))
    second = ml.bwd_outputs(ml.fused_message_layer_bwd(*args, ct, ve_dim=ve))
    plain = ml.bwd_outputs(ml.message_layer_bwd_plain(*args, ct, ve_dim=ve))
    torch.cuda.synchronize()
    worst_rel, worst_abs, worst = 0.0, 0.0, ""
    for (part, k), (_, k2), (_, p) in zip(first, second, plain):
        if not torch.equal(k, k2):
            raise AssertionError(f"backward kernel: two runs differ in {part} ({name}, {label})")
        if k.dtype != p.dtype or k.shape != p.shape or not bool(torch.isfinite(k).all()):
            raise AssertionError(f"backward kernel: {part} has the wrong dtype/shape or non-finite values")
        err = (k.float() - p.float()).abs().max().item()
        ref = p.float().abs().max().item()
        rel = err / ref if ref > 0 else (0.0 if err == 0 else float("inf"))
        if rel > TOL_BWD_REL[name]:
            raise AssertionError(f"backward kernel disagrees with the plain version: {part} "
                                 f"{name} {label}: err {err:.3g}, max|plain| {ref:.3g}")
        worst_abs = max(worst_abs, err)
        if rel >= worst_rel:
            worst_rel, worst = rel, part
    print(f"bwd-kernel-vs-plain {name} {label}: {len(first)} outputs, worst {worst} "
          f"rel={worst_rel:.3g}, max_abs_err={worst_abs:.6g}, tol={TOL_BWD_REL[name]:g}, "
          f"two runs bit-identical: ok")
    return worst_abs, worst_rel


def check_bwd_kernel(torch, evd):
    from bio_diffusion_torch.cli.profile_train import group_kernel_ms
    from bio_diffusion_torch.ops import message_layer as ml

    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, n, padded in ((8, 19, False), (8, 29, True), (2, 64, False)):
            args, ve = kernel_inputs(torch, evd, b, n, dtype, padded, seed=b * 1000 + n + 1)
            compare_bwd(torch, args, cotangents(torch, args, seed=n), ve, name,
                        f"B={b} N={n} padded={padded}")
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        # the training path's shape: both kernels held against their plain
        # versions (the weight-grad split and reduce at its full 16 splits),
        # then timed on the same inputs
        args, ve = kernel_inputs(torch, evd, 64, 29, dtype, True, seed=64)
        ct = cotangents(torch, args, seed=65)
        shape = "B=64 N=29 padded=True"
        result[f"fwd_err_b64_{name}"] = compare_fwd(torch, args, ve, name, shape)
        result[f"bwd_err_b64_{name}"] = compare_bwd(torch, args, ct, ve, name, shape)
        pairs = {
            "bwd": (lambda: ml.fused_message_layer_bwd(*args, ct, ve_dim=ve),
                    lambda: ml.message_layer_bwd_plain(*args, ct, ve_dim=ve)),
            "fwd": (lambda: ml.fused_message_layer(*args, ve_dim=ve),
                    lambda: ml.message_layer_plain(*args, ve_dim=ve)),
        }
        # bounds: the forward's products; the backward's recompute, input
        # cotangents and weight grads, ~3x the forward's products
        bounds = {
            "bwd": bound(3 * layer_flops(args, ve), nbytes(args, ct, pairs["bwd"][0]()), name),
            "fwd": bound(layer_flops(args, ve), nbytes(args, pairs["fwd"][0]()), name),
        }
        for what, (kernel_fn, plain_fn) in pairs.items():
            kernel_ms, plain_ms, runs = in_turns(torch, kernel_fn, plain_fn, reps=5)
            timings[(what, name)] = (kernel_ms, plain_ms) + bounds[what]
            print(f"timing {what} {name} B=64 N=29: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bounds[what][0]:.4f} ms ({bounds[what][1]}) (runs {runs})")
        # the backward's three kernels by name (torch.profiler), each beside
        # its bound and, for the two after the row kernel and the reduction
        # folded into the weight grads, beside the PyTorch calls of the same
        # function on a scratch of the same layout (timed before and after
        # the kernels, the better of the two kept)
        library = bwd_library_calls(torch, args, ve)
        lib_runs = {k: [device_ms_per_call(torch, fn, 5)] for k, fn in library.items()}
        sub_ms = group_kernel_ms(torch, pairs["bwd"][0], 5, "message_layer_bwd")
        for k, fn in library.items():
            lib_runs[k].append(device_ms_per_call(torch, fn, 5))
        del library
        sub_bounds = bwd_sub_bounds(args, ct, ve, name)
        # the split partials' reduction runs inside weight_grad_kernel: no
        # launch of its own, its bound and library call kept for the record
        sub_ms["reduce_kernel"] = None
        result[f"sub_kernels_{name}"] = {k: {"ms": ms, "bound_ms": sub_bounds[k][0], "bound_by": sub_bounds[k][1],
                                             "library_ms": min(lib_runs[k]) if k in lib_runs else None}
                                         for k, ms in sub_ms.items()}
        result[f"sub_kernels_{name}"]["reduce_kernel"]["folded_into"] = "weight_grad_kernel"
        for k, ms in sub_ms.items():
            lib = f", library calls {min(lib_runs[k]):.4f} ms (runs {lib_runs[k]})" if k in lib_runs else ""
            when = "folded into weight_grad_kernel" if ms is None else f"{ms:.4f} ms per launch (profiler)"
            print(f"timing bwd {name} B=64 N=29 {k}: {when}, "
                  f"bound {sub_bounds[k][0]:.4f} ms ({sub_bounds[k][1]}){lib}")
        if not all(sub_ms[k] > 0 for k in ("bwd_rows_kernel", "proj_sum_kernel", "weight_grad_kernel")):
            raise AssertionError(f"the profiler saw no backward kernel ({name}): {sub_ms}")
        if name == "float32":
            result["reductions_alone"] = {"B=64, N=29": check_bwd_reductions(torch, args, ve, shape)}
    # the kernels line reports the backward at the training path's shape and
    # default precision (float32), with the bfloat16 numbers beside them
    result["max_abs_err"], result["max_rel_err"] = result["bwd_err_b64_float32"]
    result["max_abs_err_bf16"], result["max_rel_err_bf16"] = result["bwd_err_b64_bfloat16"]
    result["ms"], result["plain_ms"], result["bound_ms"], result["bound_by"] = timings[("bwd", "float32")]
    result["ms_bf16"], result["plain_ms_bf16"], result["bound_ms_bf16"], _ = timings[("bwd", "bfloat16")]
    result["fwd_ms_b64"] = {k[1]: v[0] for k, v in timings.items() if k[0] == "fwd"}
    result["fwd_bound_ms_b64"] = {k[1]: v[2] for k, v in timings.items() if k[0] == "fwd"}
    result["bwd_ms_b64"] = {k[1]: v[0] for k, v in timings.items() if k[0] == "bwd"}
    return result


def check_denoiser_grad(torch, extra=(), label="fp32", tol=TOL_GRAD_REL):
    """Full-width denoiser, float32: parameter gradients on the card (both
    kernels) against the CPU (plain versions); ``extra`` as
    ``check_denoiser``; ``tol``: relative to max|CPU grad| of each parameter
    -> worst relative error."""
    import copy

    from bio_diffusion_torch.cli.common import load_model

    exp = qm9_experiment("fp32", extra)
    evd_gpu = load_model(exp, None, torch.device("cuda"), seed=2)
    evd_cpu = copy.deepcopy(evd_gpu).to("cpu")
    xh, t, mask, sc, gen = denoiser_inputs(torch, 4, 0.3, exp.diffusion_cfg.self_condition)
    b, n = mask.shape
    w = torch.randn(b, n, 9, generator=gen)
    grads = []
    for evd, dev in ((evd_cpu, "cpu"), (evd_gpu, "cuda")):
        dyn = evd.dynamics_network
        out = dyn(xh.to(dev), t.to(dev), mask.to(dev), **{k: v.to(dev) for k, v in sc.items()})
        params = [p for _, p in dyn.named_parameters()]
        grads.append([g.cpu() for g in torch.autograd.grad((out * w.to(dev)).sum(), params, allow_unused=True,
                                                           materialize_grads=True)])
    names = [k for k, _ in evd_cpu.dynamics_network.named_parameters()]
    floor = 1e-6 * max(g.abs().max().item() for g in grads[0])
    worst, worst_name = 0.0, ""
    for name, g_cpu, g_gpu in zip(names, *grads):
        err = (g_gpu - g_cpu).abs().max().item()
        scale = max(g_cpu.abs().max().item(), floor)
        if not bool(torch.isfinite(g_gpu).all()) or err > tol * scale:
            raise AssertionError(f"denoiser gradient of {name} on the card disagrees with the CPU: "
                                 f"err {err:.3g}, max|cpu| {scale:.3g}")
        if err / scale >= worst:
            worst, worst_name = err / scale, name
    print(f"denoiser grad card-vs-cpu {label} B={b} N={n}: {len(names)} parameters, worst {worst_name} "
          f"rel={worst:.3g} tol={tol:g} ok")
    return worst


def drive_training(torch, precision: str, steps: int, timed_steps: int):
    """``cli.train.main`` at full QM9 width on synthetic data; returns the
    launch counts of that run and the timing of further Trainer steps."""
    import copy

    import numpy as np

    from bio_diffusion_torch.cli.train import main
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train.torch_import import init_random_weights

    workdir = os.path.join(REPO, "outputs", f"train_smoke_{precision}")
    shutil.rmtree(workdir, ignore_errors=True)  # a checkpoint there would be resumed
    args = ["experiment=qm9_mol_gen_ddpm", "datamodule.dataloader_cfg.dataset=synthetic",
            "trainer.check_val_every_n_epoch=1", f"trainer.precision={precision}",
            "--device=cuda", f"--max-steps={steps}", f"--workdir={workdir}"]
    ml.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = main(args)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = dict(ml.launch_counts)
    layers = trainer.exp.model_cfg.num_encoder_layers
    st = trainer.stats
    need_fwd = layers * (st["micro_batches"] + 2 * st["eval_batches"])
    need_bwd = layers * st["micro_batches"]
    batch = trainer.exp.dataloader_cfg.batch_size
    print(f"train {precision}: cli.train.main {st['steps']} steps (batch {batch}, N=29), "
          f"{st['eval_batches']} EMA validation batches, {sec:.3f} s with set-up; launches "
          f"fwd={counts['message_layer']} (need {need_fwd}), bwd={counts['message_layer_bwd']} "
          f"(need {need_bwd})")
    if counts["message_layer"] != need_fwd or counts["message_layer_bwd"] != need_bwd or st["steps"] != steps:
        raise AssertionError("training did not launch 9 forward and 9 backward kernels per step")
    rows = trainer.loggers.loggers[0].rows
    train_rows = [r for r in rows if "train/loss" in r]
    val_rows = [r for r in rows if "valid/loss" in r]
    losses = [r["train/loss"] for r in train_rows]
    if not val_rows or not np.all(np.isfinite(losses + [r["valid/loss"] for r in val_rows])):
        raise AssertionError(f"training or EMA validation loss is not finite: {losses}")
    print(f"train {precision}: epoch losses {losses}, EMA val losses {[r['valid/loss'] for r in val_rows]}, "
          f"grad norms {[r['train/grad_norm'] for r in train_rows]}")
    # the weights the trainer started from, drawn again from the same seed
    fresh = copy.deepcopy(trainer.evd).to("cpu")
    init_random_weights(fresh, trainer.exp.seed)
    start = [p.detach() for p in fresh.parameters()]
    moved = max((p.detach().cpu() - q).abs().max().item()
                for p, q in zip(trainer.evd.parameters(), start))
    ema_moved = max((p.cpu() - q).abs().max().item() for p, q in zip(trainer.evd_ema.parameters(), start))
    print(f"train {precision}: max |param - initial| {moved:.3g}, max |EMA - initial| {ema_moved:.3g}")
    if not (moved > 0 and ema_moved > 0):
        raise AssertionError("parameters or EMA did not move")

    torch.cuda.reset_peak_memory_stats()
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start_ev.record()
    trainer.train_epoch(epoch=steps, max_steps=trainer.state.count + timed_steps)
    end_ev.record()
    torch.cuda.synchronize()
    ms = start_ev.elapsed_time(end_ev) / timed_steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train {precision}: {ms:.3f} ms/step over {timed_steps} Trainer steps (CUDA events, "
          f"after {steps} warm-up steps), peak device memory {peak:.3f} GiB")
    return counts, ms


def restored_equal(torch, trainer):
    """``restore_checkpoint`` of the newest checkpoint into zeroed copies of
    the trainer's models and state: every tensor bit-identical to the
    trainer's -> the number of tensors compared."""
    import copy

    from bio_diffusion_torch.train import checkpoints as ck
    from bio_diffusion_torch.train.state import TrainState

    evd, ema = copy.deepcopy(trainer.evd), copy.deepcopy(trainer.evd_ema)
    state = TrainState(list(evd.parameters()), list(ema.parameters()), trainer.exp.optimizer)
    with torch.no_grad():
        for t in state.params + state.ema_params + [state.gradnorm_buffer]:
            t.zero_()
    step = ck.restore_checkpoint(trainer.ckpt_dir, evd, ema, state)
    ours, ref = trainer.state, state
    if step != ours.count or (ref.count, ref.gradnorm_count) != (ours.count, ours.gradnorm_count):
        raise AssertionError(f"restored step {step}/{ref.count} differs from the trainer's {ours.count}")
    pairs = [(a, b) for key in ("params", "ema_params", "mu", "nu", "nu_max")
             for a, b in zip(getattr(ref, key), getattr(ours, key))]
    pairs.append((ref.gradnorm_buffer, ours.gradnorm_buffer))
    if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
        raise AssertionError("a restored tensor differs from the trainer's")
    return len(pairs)


def xyz_molecules(out_dir, info):
    """The molecules of the xyz files under ``out_dir`` as the server's
    molecule records (atomic numbers as charges, from the dataset's table
    where it has one: GEOM-Drugs' 16 types)."""
    import numpy as np

    from bio_diffusion_torch.chem.constants import CHARGE_DICT
    from bio_diffusion_torch.chem.molecule import load_molecule_xyz

    numbers = dict(zip(info["atom_decoder"], info["atomic_nb"])) if "atomic_nb" in info else CHARGE_DICT
    mols = []
    for root, _, files in sorted(os.walk(out_dir)):
        for name in sorted(f for f in files if f.endswith(".xyz")):
            pos, one_hot = load_molecule_xyz(os.path.join(root, name), info)
            atoms = [info["atom_decoder"][int(k)] for k in one_hot.argmax(-1)]
            mols.append({"positions": pos.astype(np.float64).tolist(), "atoms": atoms, "size": len(atoms),
                         "charges": [numbers[a] for a in atoms]})
    return mols


@contextlib.contextmanager
def spy(torch, cls, name):
    """Wrap ``cls.<name>`` (a class's method or a module's function) for the
    block: each call's host seconds (the card synchronized before and
    after), its forward-kernel launches, the shape of its second argument
    (the first after ``self``), its arguments and its result are appended to
    the list it yields."""
    from bio_diffusion_torch.ops import message_layer as ml

    orig, calls = getattr(cls, name), []

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        before, t0 = ml.launch_counts["message_layer"], time.perf_counter()
        result = orig(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append({"s": time.perf_counter() - t0, "launches": ml.launch_counts["message_layer"] - before,
                      "shape": tuple(getattr(args[1], "shape", ())) if len(args) > 1 else (),
                      "args": args, "kwargs": kwargs, "result": result})
        return result

    setattr(cls, name, wrapped)
    try:
        yield calls
    finally:
        setattr(cls, name, orig)


def drive_user_path(torch):
    """The QM9 user path from files on disk to evaluated samples, at full
    width in float32 (B=64): QM9-layout files written from a seed,
    ``cli.train.main`` (4 train batches an epoch, 2 EMA validation batches,
    one sampling evaluation of 16 molecules at T=1000), the checkpoint
    restored bit-identically, a second ``cli.train.main`` that resumes at the
    saved step, then ``cli.mol_gen_sample.main`` and ``cli.mol_gen_eval.main``
    from the checkpoint directory (64 molecules, sizes drawn, T=1000; one NLL
    pass over the test split).  Every launch count is read around the call
    that makes it (the sampling evaluation's and each sampler batch's apart)
    and held exactly against its formula -> (launches by path of the forward
    and backward kernels, numbers)."""
    import numpy as np

    from bio_diffusion_torch.cli import mol_gen_eval, mol_gen_sample, train
    from bio_diffusion_torch.data.dataset_info import get_dataset_info
    from bio_diffusion_torch.data.synthetic import write_qm9_layout
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train import checkpoints as ck
    from bio_diffusion_torch.train.loop import Trainer
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    root = os.path.join(REPO, "outputs", "user_path")
    shutil.rmtree(root, ignore_errors=True)
    data_dir, workdir = os.path.join(root, "data"), os.path.join(root, "train")
    t0 = time.perf_counter()
    write_qm9_layout(data_dir, counts=(1024, 256, 256), seed=0)
    print(f"user path: QM9-layout files (1,024/256/256 molecules, N=29 with H) written in "
          f"{time.perf_counter() - t0:.3f} s")
    args = ["experiment=qm9_mol_gen_ddpm", "datamodule.dataloader_cfg.dataset=QM9",
            f"datamodule.dataloader_cfg.data_dir={data_dir}", "datamodule.dataloader_cfg.batch_size=64",
            "trainer.precision=fp32", "trainer.check_val_every_n_epoch=1", "trainer.limit_train_batches=4",
            "trainer.limit_val_batches=2", "--device=cuda", f"--workdir={workdir}", "--max-epochs=1"]
    out, numbers = {"fwd": {}, "bwd": {}}, {}

    def run(fn):
        ml.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0, dict(ml.launch_counts)

    with spy(torch, Trainer, "evaluate_sampling") as evals, spy(torch, SegmentedSampler, "run") as batches:
        trainer, sec, counts = run(lambda: train.main(args + [
            "model.diffusion_cfg.sample_during_training=true", "model.diffusion_cfg.eval_epochs=1",
            "model.diffusion_cfg.num_eval_samples=16", "model.diffusion_cfg.eval_batch_size=16"]))
    layers, T = trainer.exp.model_cfg.num_encoder_layers, trainer.exp.diffusion_cfg.num_timesteps
    st = trainer.stats
    eval_launches = sum(c["launches"] for c in evals)
    measured = {"train_qm9": counts["message_layer"] - eval_launches, "train_sampling_eval": eval_launches}
    need = {"train_qm9": layers * (st["micro_batches"] + 2 * st["eval_batches"]),
            "train_sampling_eval": layers * (T + 1) * len(batches)}
    print(f"user path train: {st['steps']} steps, {st['eval_batches']} EMA validation batches, "
          f"{len(evals)} sampling evaluation(s) of {len(batches)} sampler batch(es) of 16 at T={T}, "
          f"{sec:.3f} s with set-up; launches fwd train {measured['train_qm9']} (need {need['train_qm9']}), "
          f"sampling eval {measured['train_sampling_eval']} (need {need['train_sampling_eval']}), "
          f"bwd={counts['message_layer_bwd']} (need {layers * st['micro_batches']})")
    if (st["steps"], len(evals), len(batches), st["sample_batches"]) != (4, 1, 1, 1) or measured != need \
            or any(c["launches"] != layers * (T + 1) for c in batches) \
            or counts["message_layer_bwd"] != layers * st["micro_batches"]:
        raise AssertionError("the QM9 training run's launch counts are not exact")
    out["fwd"].update(measured)
    out["bwd"]["train_qm9"] = counts["message_layer_bwd"]
    val = [r for r in trainer.loggers.loggers[0].rows if "val/mol_stable" in r]
    if not val or not np.isfinite(val[-1]["val/kl_div_atom_types"]):
        raise AssertionError("the sampling evaluation logged no val/ metrics")
    print(f"user path sampling eval (printed, not judged): { {k: v for k, v in val[-1].items() if k.startswith('val/')} }")
    step = ck.latest_step(trainer.ckpt_dir)
    if step != trainer.state.count:
        raise AssertionError(f"newest checkpoint step {step}, trainer at {trainer.state.count}")
    print(f"user path checkpoint {ck.checkpoint_path(trainer.ckpt_dir, step)}: restore_checkpoint gives "
          f"{restored_equal(torch, trainer)} tensors bit-identical to the trainer's: ok")

    resumed, sec, counts = run(lambda: train.main(args + ["model.diffusion_cfg.sample_during_training=false"]))
    st = resumed.stats
    if resumed.start_step != step or resumed.state.count != step + st["steps"] or st["steps"] < 1:
        raise AssertionError(f"resume started at {resumed.start_step} (saved {step}), ran to {resumed.state.count}")
    if counts["message_layer"] != layers * (st["micro_batches"] + 2 * st["eval_batches"]) \
            or counts["message_layer_bwd"] != layers * st["micro_batches"]:
        raise AssertionError("the resumed run's launch counts are not exact")
    out["fwd"]["train_qm9"] += counts["message_layer"]
    out["bwd"]["train_qm9"] += counts["message_layer_bwd"]
    print(f"user path resume: started at step {resumed.start_step}, ran to {resumed.state.count} in {sec:.3f} s")
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start_ev.record()
    resumed.train_epoch(epoch=1)
    end_ev.record()
    torch.cuda.synchronize()
    numbers["train_ms_per_step"] = start_ev.elapsed_time(end_ev) / 4
    print(f"user path train: {numbers['train_ms_per_step']:.3f} ms/step over 4 further Trainer steps on the "
          f"QM9-layout files (fp32, B=64, N=29, CUDA events)")

    info = get_dataset_info("QM9")
    cli = [f"ckpt_path={trainer.ckpt_dir}", "device=cuda", "precision=fp32", "num_samples=64",
           "sampling_batch_size=64"]
    with spy(torch, SegmentedSampler, "run") as batches:
        metrics, sec, counts = run(lambda: mol_gen_sample.main(cli + [f"output_dir={root}/samples"]))
    mols = xyz_molecules(os.path.join(root, "samples"), info)
    check_molecules(mols, 64)
    if len(batches) != 1 or counts["message_layer"] != layers * (T + 1) \
            or batches[0]["launches"] != counts["message_layer"]:
        raise AssertionError(f"mol_gen_sample launched {counts['message_layer']} in {len(batches)} sampler "
                             f"batch(es), need {layers * (T + 1)} in one")
    out["fwd"]["sample_cli"] = counts["message_layer"]
    loop_s = batches[0]["s"]
    numbers.update(sample_s_per_step=loop_s / T, sample_mol_per_s=64 / loop_s, sample_cli_s=sec)
    print(f"user path mol_gen_sample: 64 xyz files (sizes {sorted(m['size'] for m in mols)}), molecules pass the "
          f"checks; the sampler's batch of 64 (prior, T={T} reverse steps, decode) took {loop_s:.3f} s = "
          f"{loop_s / T:.6f} s per reverse step, {64 / loop_s:.3f} molecules/s; the CLI call {sec:.3f} s with "
          f"set-up; launches {counts['message_layer']}; metrics (printed, not judged) {metrics}")

    with spy(torch, SegmentedSampler, "run") as batches:
        metrics, sec, counts = run(lambda: mol_gen_eval.main(cli + [
            "num_test_passes=1", f"datamodule.dataloader_cfg.data_dir={data_dir}", f"output_dir={root}/eval"]))
    with open(os.path.join(root, "eval", "eval_results.json")) as f:
        saved = json.load(f)
    test_batches = -(-256 // 64)
    if not np.isfinite(saved.get("test_nll", float("nan"))) or saved != metrics:
        raise AssertionError(f"eval_results.json has no finite test_nll: {saved}")
    sampled = sum(c["launches"] for c in batches)
    if len(batches) != 1 or sampled != layers * (T + 1) \
            or counts["message_layer"] - sampled != layers * 2 * test_batches:
        raise AssertionError(f"mol_gen_eval launched {sampled} in {len(batches)} sampler batch(es) (need "
                             f"{layers * (T + 1)} in one) and {counts['message_layer'] - sampled} for the NLL "
                             f"(need {layers * 2 * test_batches})")
    out["fwd"]["eval_cli"] = counts["message_layer"]
    numbers["eval_s"] = sec
    print(f"user path mol_gen_eval: {sec:.3f} s, test_nll {saved['test_nll']:.6g} (finite), launches "
          f"{counts['message_layer']}; metrics (printed, not judged) {saved}")
    return out, numbers


SC_LEARNED = ("model.diffusion_cfg.self_condition=true", "model.diffusion_cfg.noise_schedule=learned",
              "model.diffusion_cfg.loss_type=vlb")


def drive_sc_learned_path(torch, data_dir):
    """Self-conditioning and the learned noise schedule at full QM9 width
    (``qm9_mol_gen_ddpm``, 9 layers, T=1000, with ``SC_LEARNED``), float32,
    on the user path's QM9-layout files: (a) the denoiser with a nonzero
    self-conditioning input and its parameter gradients, card against CPU;
    (b) ``cli.train.main`` (B=64, 4 train batches, 2 EMA validation
    batches), each train step's forward launches read around it and held at
    9, or 18 where that step's own draws (``loss_draws``: ``sc_take`` and no
    t_int = T) run the self-conditioning pass, 9 backward launches a step,
    18 forward a validation batch, a finite loss and the schedule's
    endpoints moved from -5 and 10; (c) ``cli.mol_gen_sample.main`` from its
    checkpoint, 64 molecules at T=1000: 9 x (2 x 1000 + 1) = 18,009 forward
    launches, the decoded batch and the xyz molecules checked -> (launches
    by path, numbers)."""
    import numpy as np

    from bio_diffusion_torch.cli import mol_gen_sample, train
    from bio_diffusion_torch.data.dataset_info import get_dataset_info
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train import loop
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    numbers = {"denoiser_max_abs_err": check_denoiser(torch, SC_LEARNED, "sc+learned fp32"),
               "denoiser_grad_worst_rel": check_denoiser_grad(torch, SC_LEARNED, "sc+learned fp32")}
    root = os.path.join(REPO, "outputs", "sc_learned_path")
    shutil.rmtree(root, ignore_errors=True)
    workdir = os.path.join(root, "train")
    args = ["experiment=qm9_mol_gen_ddpm", *SC_LEARNED, "datamodule.dataloader_cfg.dataset=QM9",
            f"datamodule.dataloader_cfg.data_dir={data_dir}", "datamodule.dataloader_cfg.batch_size=64",
            "trainer.precision=fp32", "trainer.check_val_every_n_epoch=1", "trainer.limit_train_batches=4",
            "trainer.limit_val_batches=2", "model.diffusion_cfg.sample_during_training=false", "--device=cuda",
            f"--workdir={workdir}", "--max-epochs=1"]
    steps = []  # per train step: forward and backward launches, host seconds (synchronized)
    orig_make = loop.make_train_step

    def make(*a, **k):
        step = orig_make(*a, **k)

        def run(*sa, **sk):
            torch.cuda.synchronize()
            fwd, bwd, t0 = ml.launch_counts["message_layer"], ml.launch_counts["message_layer_bwd"], time.perf_counter()
            result = step(*sa, **sk)
            torch.cuda.synchronize()
            steps.append((ml.launch_counts["message_layer"] - fwd, ml.launch_counts["message_layer_bwd"] - bwd,
                          time.perf_counter() - t0))
            return result
        return run

    loop.make_train_step = make
    try:
        with spy(torch, EquivariantVariationalDiffusion, "loss_draws") as draws:
            trainer, sec, counts = count_run(torch, lambda: train.main(args))
    finally:
        loop.make_train_step = orig_make
    layers, T = trainer.exp.model_cfg.num_encoder_layers, trainer.exp.diffusion_cfg.num_timesteps
    st = trainer.stats
    train_draws = [c["result"] for c in draws if "sc_take" in c["result"]]
    taken = [bool(d["sc_take"]) and not bool((d["t_int"] == T).any()) for d in train_draws]
    need_steps = [(layers * (2 if sc else 1), layers) for sc in taken]
    got_steps = [(f, b) for f, b, _ in steps]
    eval_fwd = counts["message_layer"] - sum(f for f, _ in got_steps)
    print(f"sc+learned train: {st['steps']} steps (B=64, N=29), self-conditioning pass taken {taken}; launches "
          f"per step (fwd, bwd) {got_steps} (need {need_steps}); validation fwd {eval_fwd} (need "
          f"{2 * layers * st['eval_batches']} for {st['eval_batches']} batches); {sec:.3f} s with set-up")
    if st["steps"] != 4 or len(train_draws) != 4 or got_steps != need_steps \
            or eval_fwd != 2 * layers * st["eval_batches"] or counts["message_layer_bwd"] != 4 * layers:
        raise AssertionError("the self-conditioned training run's launch counts are not exact")
    rows = trainer.loggers.loggers[0].rows
    losses = [r["train/loss"] for r in rows if "train/loss" in r] + [r["valid/loss"] for r in rows if "valid/loss" in r]
    g0, g1 = trainer.evd.gamma.gamma_0.item(), trainer.evd.gamma.gamma_1.item()
    if not losses or not np.all(np.isfinite(losses)) or g0 == -5.0 or g1 == 10.0:
        raise AssertionError(f"losses {losses}, schedule endpoints ({g0}, {g1})")
    ms = [1e3 * t for _, _, t in steps]
    numbers.update(train_ms_per_step=ms, sc_taken=taken, gamma_0=g0, gamma_1=g1)
    print(f"sc+learned train: losses {losses} (finite), gamma_0 {g0:.6g}, gamma_1 {g1:.6g} (moved from -5, 10); "
          f"ms/step {[round(v, 3) for v in ms]} (host, synchronized; 18-launch steps where the pass ran)")
    out = {"fwd": {"sc_train": counts["message_layer"]}, "bwd": {"sc_train": counts["message_layer_bwd"]}}

    cli = [*SC_LEARNED, f"ckpt_path={trainer.ckpt_dir}", "device=cuda", "precision=fp32", "num_samples=64",
           "sampling_batch_size=64", f"output_dir={root}/samples"]
    with spy(torch, SegmentedSampler, "run") as batches:
        metrics, sec, counts = count_run(torch, lambda: mol_gen_sample.main(cli))
    need = layers * (2 * T + 1)
    if len(batches) != 1 or counts["message_layer"] != need or batches[0]["launches"] != need:
        raise AssertionError(f"sc+learned mol_gen_sample launched {counts['message_layer']} in {len(batches)} "
                             f"batch(es), need {need} in one")
    # positions and types of the decoded batch (the charges of untrained
    # weights can overflow float32 over 1000 steps, as in every path)
    xh, mask = batches[0]["result"], np.asarray(batches[0]["args"][1])
    real = mask > 0
    k = len(get_dataset_info("QM9")["atom_decoder"])
    xk = xh[..., :3 + k]
    faults = {"non-finite positions": not np.isfinite(xk).all(), "nonzero padded rows": bool(np.any(xk[~real] != 0)),
              "not one type a real atom": bool(np.any(xk[..., 3:][real].sum(-1) != 1)),
              "non-finite charges": not np.isfinite(xh[..., 3 + k:]).all()}
    print(f"sc+learned samples: {faults}")
    if any(v for f, v in faults.items() if f != "non-finite charges"):
        raise AssertionError(f"sc+learned samples: {faults}")
    check_molecules(xyz_molecules(os.path.join(root, "samples"), get_dataset_info("QM9")), 64)
    loop_s = batches[0]["s"]
    out["fwd"]["sc_sample_cli"] = counts["message_layer"]
    numbers.update(sample_s_per_step=loop_s / T, sample_mol_per_s=64 / loop_s, sample_cli_s=sec)
    print(f"sc+learned mol_gen_sample: 64 molecules pass the checks; the sampler's batch of 64 (prior, T={T} "
          f"steps of 2 denoiser calls, decode) took {loop_s:.3f} s = {loop_s / T:.6f} s per reverse step, "
          f"{64 / loop_s:.3f} molecules/s; the CLI call {sec:.3f} s with set-up; launches {counts['message_layer']} "
          f"(need {need}); metrics (printed, not judged) {metrics}")
    return out, numbers


def check_module_grads(torch, extra, label):
    """A module-path denoiser's parameter gradients, float32, on the card and
    on the CPU against the CPU in float64 (same weights and inputs): each
    card gradient within TOL_MODULE_GRAD_REL of its own scale of the float64
    one, or within twice the CPU float32 gradient's distance from it ->
    (worst relative error, parameters judged by that second rule)."""
    import copy

    from bio_diffusion_torch.cli.common import load_model

    exp = qm9_experiment("fp32", extra)
    evd_gpu = load_model(exp, None, torch.device("cuda"), seed=2)
    evd_cpu = copy.deepcopy(evd_gpu).to("cpu")
    xh, t, mask, sc, gen = denoiser_inputs(torch, 4, 0.3, exp.diffusion_cfg.self_condition)
    w = torch.randn(mask.shape + (9,), generator=gen)
    grads = []
    for evd, dev, dt in ((evd_cpu, "cpu", torch.float64), (evd_cpu, "cpu", torch.float32),
                         (evd_gpu, "cuda", torch.float32)):
        dyn = evd.dynamics_network
        if dt == torch.float64:  # the body in float64 too
            dyn = copy.deepcopy(dyn).to(dt)
            dyn.compute_dtype = dt
        out = dyn(*(a.to(dev, dt) for a in (xh, t, mask)), **{k: v.to(dev, dt) for k, v in sc.items()})
        grads.append([g.cpu().double() for g in torch.autograd.grad(
            (out * w.to(dev, dt)).sum(), list(dyn.parameters()), allow_unused=True, materialize_grads=True)])
    names = [k for k, _ in evd_cpu.dynamics_network.named_parameters()]
    floor = 1e-6 * max(g.abs().max().item() for g in grads[0])
    worst, worst_name, conditioned = 0.0, "", []
    for name, g64, g_cpu, g_gpu in zip(names, *grads):
        scale = max(g64.abs().max().item(), floor)
        err, cpu_err = (g_gpu - g64).abs().max().item(), (g_cpu - g64).abs().max().item()
        if not bool(torch.isfinite(g_gpu).all()) or err > max(TOL_MODULE_GRAD_REL * scale, 2 * cpu_err):
            raise AssertionError(f"{label}: the card's gradient of {name} is {err:.3g} from float64 (scale "
                                 f"{scale:.3g}; the CPU's float32 {cpu_err:.3g})")
        if err > TOL_MODULE_GRAD_REL * scale:
            conditioned.append(name)
        if err / scale >= worst:
            worst, worst_name = err / scale, name
    print(f"denoiser grad card-vs-cpu-f64 {label}: {len(names)} parameters, worst {worst_name} rel={worst:.3g}; "
          f"{len(conditioned)} within twice the CPU float32's own error {conditioned[:4]} ok")
    return worst, conditioned


def module_step_timer(torch, steps):
    """A ``loop.make_train_step`` that appends each step's forward and
    backward launches and host seconds (synchronized) to ``steps``."""
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train import loop

    orig_make = loop.make_train_step

    def make(*a, **k):
        step = orig_make(*a, **k)

        def run(*sa, **sk):
            torch.cuda.synchronize()
            fwd, bwd, t0 = ml.launch_counts["message_layer"], ml.launch_counts["message_layer_bwd"], time.perf_counter()
            result = step(*sa, **sk)
            torch.cuda.synchronize()
            steps.append((ml.launch_counts["message_layer"] - fwd, ml.launch_counts["message_layer_bwd"] - bwd,
                          time.perf_counter() - t0, float(result["loss"])))
            return result
        return run

    return make


def fast_train_off_steps(torch, data_dir, root):
    """The shipped QM9 configuration, fp32, B=64 on the QM9-layout files: 3
    Trainer steps with ``trainer.fast_train=off`` (the module forward) and 3
    with ``auto`` (the packed forward), the same weights, batches and draws.
    Step 1's loss must agree within TOL_FAST_OFF_REL; the off steps launch
    neither kernel, the auto steps 9 + 9 each -> (launches, numbers)."""
    from bio_diffusion_torch.config.build import build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train.loop import Trainer

    runs = {}
    for fast in ("off", "auto"):
        cfg = load_config(default_config_dir(), "train", [
            "experiment=qm9_mol_gen_ddpm", "datamodule.dataloader_cfg.dataset=QM9",
            f"datamodule.dataloader_cfg.data_dir={data_dir}", "datamodule.dataloader_cfg.batch_size=64",
            "trainer.precision=fp32", f"trainer.fast_train={fast}"])
        trainer = Trainer(build_experiment(cfg), os.path.join(root, f"fast_{fast}"), "cuda")
        trainer.init_state(resume=False)
        batches = [b.to("cuda") for _, b in zip(range(3), trainer._train_batches())]
        steps = []
        for batch in batches:
            torch.cuda.synchronize()
            fwd, bwd, t0 = ml.launch_counts["message_layer"], ml.launch_counts["message_layer_bwd"], time.perf_counter()
            metrics = trainer.train_step(trainer.state, batch, trainer.step_generator())
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            steps.append((ml.launch_counts["message_layer"] - fwd, ml.launch_counts["message_layer_bwd"] - bwd,
                          time.perf_counter() - t0, loss))
        runs[fast] = (trainer.evd.dynamics_network.packed, steps)
        del trainer
    (off_packed, off), (auto_packed, auto) = runs["off"], runs["auto"]
    rel = abs(off[0][3] - auto[0][3]) / abs(auto[0][3])
    layers = 9
    print(f"fast_train=off: packed={off_packed}, losses {[s[3] for s in off]}, launches (fwd, bwd) "
          f"{[s[:2] for s in off]}; auto: packed={auto_packed}, losses {[s[3] for s in auto]}, launches "
          f"{[s[:2] for s in auto]}; step 1 loss rel diff {rel:.3g} (tol {TOL_FAST_OFF_REL:g})")
    if off_packed or not auto_packed or rel > TOL_FAST_OFF_REL or any(s[:2] != (0, 0) for s in off) \
            or any(s[:2] != (layers, layers) for s in auto):
        raise AssertionError("fast_train=off did not take the module path with the packed path's step-1 loss")
    ms_off, ms_auto = [1e3 * s[2] for s in off], [1e3 * s[2] for s in auto]
    print(f"fast_train=off: ms/step module path {[round(v, 3) for v in ms_off]}, packed path "
          f"{[round(v, 3) for v in ms_auto]} (host, synchronized; step 1 includes warm-up)")
    launches = {"fwd": {"fast_train_auto_steps": sum(s[0] for s in auto), "fast_train_off_steps": 0},
                "bwd": {"fast_train_auto_steps": sum(s[1] for s in auto), "fast_train_off_steps": 0}}
    return launches, {"step1_loss_rel_diff": rel, "ms_per_step_off": ms_off, "ms_per_step_auto": ms_auto}


def drive_module_paths(torch, data_dir):
    """The module-path denoisers at full QM9 width (``qm9_mol_gen_ddpm``, 9
    layers, S=256, V=32, Se=64, Ve=16), float32, weights from
    ``init_random_weights``, in the four configurations of ``MODULE_PATHS``:
    for each (a) the denoiser, card against CPU (TOL_MODULE_DENOISER_REL),
    and its parameter gradients, card against the CPU's float64
    (``check_module_grads``); (b) ``cli.train.main`` on
    the user path's QM9-layout files, 3 steps at B=64 (N=29): finite losses,
    ms a step, peak memory, no B1 or B2 launch; (c)
    ``cli.mol_gen_sample.main`` of 16 molecules from its checkpoint at
    ``num_timesteps=MODULE_SAMPLE_T`` (a reduced depth): the xyz molecules
    pass ``check_molecules``, s a reverse step, no launch.  Then
    ``fast_train_off_steps`` -> (launches by path, numbers)."""
    import numpy as np

    from bio_diffusion_torch.cli import mol_gen_sample, train
    from bio_diffusion_torch.data.dataset_info import get_dataset_info
    from bio_diffusion_torch.train import loop
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    root = os.path.join(REPO, "outputs", "module_paths")
    shutil.rmtree(root, ignore_errors=True)
    out, numbers = {"fwd": {}, "bwd": {}}, {}
    for name, extra in MODULE_PATHS.items():
        grad_rel, conditioned = check_module_grads(torch, extra, f"module path {name} fp32")
        n = {"denoiser_max_abs_err": check_denoiser(torch, extra, f"module path {name} fp32",
                                                    TOL_MODULE_DENOISER_REL),
             "denoiser_grad_worst_rel": grad_rel, "grads_within_cpu_f32_error": conditioned}
        workdir = os.path.join(root, name, "train")
        args = ["experiment=qm9_mol_gen_ddpm", *extra, "datamodule.dataloader_cfg.dataset=QM9",
                f"datamodule.dataloader_cfg.data_dir={data_dir}", "datamodule.dataloader_cfg.batch_size=64",
                "trainer.precision=fp32", "trainer.check_val_every_n_epoch=2", "trainer.limit_train_batches=3",
                "model.diffusion_cfg.sample_during_training=false", "--device=cuda", f"--workdir={workdir}",
                "--max-epochs=1"]
        steps = []
        orig_make = loop.make_train_step
        loop.make_train_step = module_step_timer(torch, steps)
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer, sec, counts = count_run(torch, lambda: train.main(args))
        finally:
            loop.make_train_step = orig_make
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [s[3] for s in steps]
        print(f"module path {name}: cli.train {trainer.stats['steps']} steps (B=64, N=29), packed="
              f"{trainer.evd.dynamics_network.packed}, losses {losses}, ms/step "
              f"{[round(1e3 * s[2], 3) for s in steps]} (host, synchronized; step 1 includes warm-up), peak "
              f"device memory {peak:.3f} GiB, launches fwd={counts['message_layer']} "
              f"bwd={counts['message_layer_bwd']} (need 0, 0); {sec:.3f} s with set-up")
        if trainer.stats["steps"] != 3 or len(steps) != 3 or trainer.evd.dynamics_network.packed \
                or not np.all(np.isfinite(losses)) or counts["message_layer"] or counts["message_layer_bwd"]:
            raise AssertionError(f"module path {name}: the training run is not 3 finite kernel-free steps")
        out["fwd"][f"module_{name}_train"] = counts["message_layer"]
        out["bwd"][f"module_{name}_train"] = counts["message_layer_bwd"]
        n.update(train_losses=losses, train_ms_per_step=[1e3 * s[2] for s in steps], train_peak_gib=peak)

        cli = [*extra, f"ckpt_path={trainer.ckpt_dir}", "device=cuda", "precision=fp32", "num_samples=16",
               "sampling_batch_size=16", f"model.diffusion_cfg.num_timesteps={MODULE_SAMPLE_T}",
               f"output_dir={root}/{name}/samples"]
        del trainer
        with spy(torch, SegmentedSampler, "run") as batches:
            _, sec, counts = count_run(torch, lambda: mol_gen_sample.main(cli))
        check_molecules(xyz_molecules(os.path.join(root, name, "samples"), get_dataset_info("QM9")), 16)
        loop_s = sum(c["s"] for c in batches)
        print(f"module path {name}: mol_gen_sample of 16 molecules at T={MODULE_SAMPLE_T} (reduced depth) in "
              f"{len(batches)} sampler batch(es): molecules pass the checks, {loop_s:.3f} s in the sampler = "
              f"{loop_s / MODULE_SAMPLE_T:.6f} s per reverse step; the CLI call {sec:.3f} s with set-up; launches "
              f"{counts['message_layer']} (need 0)")
        if counts["message_layer"] or not batches:
            raise AssertionError(f"module path {name}: sampling launched the message-layer kernel")
        out["fwd"][f"module_{name}_sample_cli"] = counts["message_layer"]
        n.update(sample_s_per_step=loop_s / MODULE_SAMPLE_T, sample_cli_s=sec)
        numbers[name] = n
    off_launches, numbers["fast_train_off"] = fast_train_off_steps(torch, data_dir, root)
    for kind in ("fwd", "bwd"):
        out[kind].update(off_launches[kind])
    return out, numbers


def batch_recorder(torch, batches):
    """A ``loop.make_train_step`` that appends each step's batch (numpy
    copies of its tensors) to ``batches``."""
    from bio_diffusion_torch.train import loop

    orig_make = loop.make_train_step

    def make(*a, **k):
        step = orig_make(*a, **k)

        def run(state, batch, *sa, **sk):
            batches.append([getattr(batch, f).detach().cpu().numpy() for f in ("x", "one_hot", "charges", "node_mask")])
            return step(state, batch, *sa, **sk)
        return run

    return make


def tools_train(torch, data_dir, root, card):
    """Phase (a) of ``drive_tools`` -> (its launches, numbers)."""
    import numpy as np

    from bio_diffusion_torch.cli import train
    from bio_diffusion_torch.data import batch as batch_mod
    from bio_diffusion_torch.data import native_loader
    from bio_diffusion_torch.train import loop
    from bio_diffusion_torch.utils.logging import read_scalar_events

    workdir = os.path.join(root, "train")
    args = ["experiment=qm9_mol_gen_ddpm", "logger=many_loggers", "extras.print_config=true",
            "datamodule.dataloader_cfg.dataset=QM9", f"datamodule.dataloader_cfg.data_dir={data_dir}",
            "datamodule.dataloader_cfg.batch_size=64", "trainer.precision=fp32", "trainer.limit_train_batches=2",
            "trainer.check_val_every_n_epoch=2", "model.diffusion_cfg.sample_during_training=false",
            "--device=cuda", f"--workdir={workdir}", "--max-epochs=1"]
    collated, batches = [], []
    orig_collate, orig_make = native_loader.collate_dense_native, loop.make_train_step

    def collate(positions, charges, sel, n_pad, species):
        out = orig_collate(positions, charges, sel, n_pad, species)
        collated.append((positions, np.array(sel), n_pad, out))
        return out

    native_loader.collate_dense_native = collate
    loop.make_train_step = batch_recorder(torch, batches)
    try:
        trainer, sec, counts = count_run(torch, lambda: train.main(args))
    finally:
        native_loader.collate_dense_native, loop.make_train_step = orig_collate, orig_make
    # every batch through the native collation, each equal to numpy's of its molecules
    by_positions = {id(ds.data["positions"]): ds for ds in trainer.datasets.values()}
    train_calls = [c for c in collated if by_positions[id(c[0])] is trainer.datasets["train"]]
    if trainer.stats["steps"] != 2 or len(batches) != 2 or len(train_calls) < 2 or any(c[3] is None for c in collated):
        raise AssertionError(f"tools (a): {trainer.stats['steps']} steps, {len(batches)} step batches, "
                             f"{len(train_calls)} native train collations (need 2, 2, >= 2, none refused)")
    for i, (positions, sel, n_pad, out) in enumerate(collated):
        x, oh, ch, mask = batch_mod.collate_numpy(by_positions[id(positions)], sel, n_pad)
        native = (out[0], out[1], out[2][..., None], out[3])
        if not all(a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(native, (x, oh, ch, mask))):
            raise AssertionError(f"tools (a): native collation {i} differs from numpy's for the same molecules")
    for step_batch, (_, _, _, out) in zip(batches, train_calls):
        native = (out[0], out[1], out[2][..., None], out[3])
        if not all(a.tobytes() == b.tobytes() for a, b in zip(step_batch, native)):
            raise AssertionError("tools (a): a step's batch is not its native collation")
    # the logs: metrics.jsonl and the event file hold metrics.csv's steps and scalars
    with open(os.path.join(workdir, "metrics.csv")) as f:
        csv_rows = list(csv.DictReader(f))
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        jsonl_rows = [json.loads(line) for line in f]
    want = [(int(r["step"]), k, float(v)) for r in csv_rows for k, v in r.items()
            if k not in ("step", "epoch", "time") and v not in ("", None)]
    got_jsonl = [(r["step"], k, v) for r in jsonl_rows for k, v in r.items()
                 if k not in ("step", "epoch", "time") and v is not None]
    events = read_scalar_events(os.path.join(workdir, "tensorboard"))
    if not want or got_jsonl != want or [(s, t, np.float32(v)) for s, t, v in events] != \
            [(s, t, np.float32(v)) for s, t, v in want]:
        raise AssertionError(f"tools (a): the logs differ: csv {want[:4]}..., jsonl {got_jsonl[:4]}..., "
                             f"events {events[:4]}...")
    print(f"tools (a) cli.train logger=many_loggers, 2 steps at B=64 (fp32): {len(want)} scalars over steps "
          f"{sorted({w[0] for w in want})} equal in metrics.csv, metrics.jsonl and {len(events)} TensorBoard "
          f"events; {len(collated)} native collations ({len(train_calls)} train), each equal to numpy's bit for bit, "
          f"the 2 step batches among them; launches fwd={counts['message_layer']} bwd={counts['message_layer_bwd']} "
          f"(need 18, 18); {sec:.3f} s with set-up [{card}]")
    if counts["message_layer"] != 18 or counts["message_layer_bwd"] != 18:
        raise AssertionError("tools (a): the training run's launch counts are not 9 + 9 a step")
    return counts, {"train_s": sec, "scalars": len(want), "native_collations": len(collated)}


def drive_tools(torch, data_dir):
    """The tools phase at full QM9 width on the user path's QM9-layout files
    (docstring item 22) -> (launches by path, numbers)."""
    import numpy as np
    import yaml

    from bio_diffusion_torch.cli import (
        bench_shape_sweep,
        bench_train_step,
        first_contact,
        generate_grid_search_runs,
        generate_k8s_jobs,
        hparam_search,
    )
    from bio_diffusion_torch.cli.common import load_model
    from bio_diffusion_torch.config.build import build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.train.checkpoints import reference_state_dict
    from bio_diffusion_torch.train.torch_import import init_random_weights

    root = os.path.join(REPO, "outputs", "tools")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    card = card_line()
    out, numbers = {"fwd": {}, "bwd": {}}, {}

    def keep(path, counts):
        out["fwd"][path], out["bwd"][path] = counts["message_layer"], counts["message_layer_bwd"]

    counts, numbers["train"] = tools_train(torch, data_dir, root, card)
    keep("tools_train", counts)

    # (b) the hyperparameter search: 2 random trials of 2 steps
    space = os.path.join(root, "space.json")
    with open(space, "w") as f:
        json.dump({"model.optimizer.lr": "choice(0.001, 0.0001)"}, f)
    search = os.path.join(root, "search")
    _, sec, counts = count_run(torch, lambda: hparam_search.main([
        space, search, "--n-trials", "2", "--metric", "train/loss", "--sampler", "random", "--max-steps", "2",
        "--device", "cuda", "--", "experiment=qm9_mol_gen_ddpm", "datamodule.dataloader_cfg.dataset=QM9",
        f"datamodule.dataloader_cfg.data_dir={data_dir}", "datamodule.dataloader_cfg.batch_size=64",
        "trainer.precision=fp32", "trainer.check_val_every_n_epoch=2",
        "model.diffusion_cfg.sample_during_training=false", "extras.print_config=false"]))
    with open(os.path.join(search, "study.json")) as f:
        study = json.load(f)
    done = [t for t in study["trials"] if t.get("value") is not None and np.isfinite(t["value"])]
    with open(os.path.join(search, "best_trial.json")) as f:
        best = json.load(f)
    print(f"tools (b) cli.hparam_search: {len(done)} complete trials of 2 steps (values "
          f"{[t['value'] for t in done]}), best trial {best['number']}; launches fwd={counts['message_layer']} "
          f"bwd={counts['message_layer_bwd']} (need 36, 36); {sec:.3f} s [{card}]")
    if len(study["trials"]) != 2 or len(done) != 2 or best["value"] != min(t["value"] for t in done) \
            or counts["message_layer"] != 36 or counts["message_layer_bwd"] != 36:
        raise AssertionError("tools (b): the study is not 2 complete trials of 2 kernel steps with a best one")
    keep("tools_hparam_search", counts)
    numbers["hparam_search_s"] = sec

    # (c) a 2-run grid and its GPU Jobs
    grid = os.path.join(root, "grid.json")
    with open(grid, "w") as f:
        json.dump({"model.optimizer.lr": [1e-4, 4e-4]}, f)
    manifest = generate_grid_search_runs.main([grid, os.path.join(root, "grid")])
    paths = generate_k8s_jobs.main(["--manifest", os.path.join(root, "grid", "grid_manifest.json"),
                                    "--out-dir", os.path.join(root, "k8s"), "--num-hosts", "2"])
    jobs = [d for d in (yaml.safe_load(open(p)) for p in paths) if d["kind"] == "Job"]
    ctrs = [j["spec"]["template"]["spec"]["containers"][0] for j in jobs]
    if len(manifest) != 2 or len(jobs) != 2 or not all(
            c["resources"]["limits"]["nvidia.com/gpu"] == 8 and c["command"][-1].startswith("torchrun ")
            and "-m bio_diffusion_torch.cli.train " in c["command"][-1] for c in ctrs):
        raise AssertionError("tools (c): the grid's Jobs do not ask for nvidia.com/gpu under torchrun")
    print(f"tools (c) a 2-run grid -> {len(paths)} YAMLs (PVC, 2 Jobs, 2 headless Services) that parse; "
          f"nvidia.com/gpu 8 a pod under torchrun")

    # (d) the shape sweep, bf16
    result, sec, counts = count_run(torch, lambda: bench_shape_sweep.main(
        ["--cross", "--steps", "20", "--batches", "32", "250", "--nodes", "19", "29"]))
    for r in result["rows"]:
        print(f"tools (d) bench_shape_sweep B={r['batch']} N={r['nodes']}: {r['evals_per_s']} evals/s, "
              f"{r['us_per_mol_step']} us a molecule-step, {r['launches']} launches (need 9 x 21) [{card}]")
    print(f"tools (d) n_exponent {result['n_exponent']} at B={result['fit_batch']}; {sec:.3f} s [{card}]")
    if len(result["rows"]) != 3 or any(r["launches"] != 9 * 21 for r in result["rows"]) \
            or counts["message_layer"] != 2 * 9 * 21 * 3:
        raise AssertionError("tools (d): the sweep's runs are not 9 launches a denoiser call")
    keep("tools_shape_sweep", counts)
    numbers["shape_sweep"] = result

    # (e) the train-step benchmark, fp32, with the split
    result, sec, counts = count_run(torch, lambda: bench_train_step.main(
        ["--batch", "64", "--nodes", "29", "--precision", "fp32", "--steps", "3", "--split"]))
    paths_out = result["paths"]
    losses = {p: r["loss_step1"] for p, r in paths_out.items()}
    rel = max(abs(v - losses["kernel"]) for v in losses.values()) / abs(losses["kernel"])
    split = result["split"]
    print("tools (e) bench_train_step B=64 N=29 fp32: ms a step " + ", ".join(
        f"{p} {r['ms_per_step']:.3f}" for p, r in paths_out.items()) + f"; step-1 losses {losses} "
          f"({rel:.2e} apart, need <= {TOL_TOOLS_LOSS_REL}); launches by path "
          f"{ {p: r['launches'] for p, r in paths_out.items()} } [{card}]")
    print(f"tools (e) split of the kernel path: fwd {split['fwd_ms']:.3f} ms, bwd {split['bwd_ms']:.3f} ms, "
          f"clip+opt+ema {split['glue_ms']:.3f} ms, {split['flops_fwd_bwd']:.4e} FLOP fwd+bwd (module path), "
          f"MFU(step) {100 * split['mfu_step']:.3f}% of 67 TFLOP/s fp32; {sec:.3f} s [{card}]")
    if paths_out["kernel"]["launches"] != {"message_layer": 9 * 4, "message_layer_bwd": 9 * 4} \
            or any(paths_out[p]["launches"] != {"message_layer": 0, "message_layer_bwd": 0} for p in ("module", "plain")) \
            or not rel <= TOL_TOOLS_LOSS_REL or not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError("tools (e): launches or step-1 losses of the three paths are off")
    keep("tools_train_step", counts)
    numbers["train_step"] = result

    # (f) first_contact on a reference-layout checkpoint of seed weights
    exp = build_experiment(load_config(default_config_dir(), "mol_gen_eval", []))
    evd = load_model(exp, None, torch.device("cpu"), seed=11)
    ckpt = os.path.join(root, "seed-EMA.ckpt")
    torch.save({"state_dict": reference_state_dict(evd), "epoch": 0}, ckpt)
    n_params = sum(1 for _ in evd.parameters())
    del evd
    report_path = os.path.join(root, "first_contact.json")
    rc, sec, counts = count_run(torch, lambda: first_contact.main(
        ["--ckpt", ckpt, "--num-samples", "16", "--num-timesteps", "100", "--batch", "16", "--out", report_path]))
    with open(report_path) as f:
        report = json.load(f)
    checks = report["checks"]
    print(f"tools (f) first_contact (16 molecules, T=100, seed weights): exit {rc}, pass {report['pass']}, import "
          f"{checks['import']} of {n_params} parameters, checks " + ", ".join(
              f"{k} {v.get('value')} (target {v.get('target')}, tolerance {v.get('tolerance')})"
              for k, v in checks.items() if k in first_contact.TARGETS)
          + f"; launches {counts['message_layer']} (need 9 x 101); {sec:.3f} s [{card}]")
    if rc != 1 or report["pass"] is not False or checks["import"] != {"ok": True, "leaves": n_params} \
            or any("tolerance" not in checks.get(k, {}) for k in first_contact.TARGETS) \
            or counts["message_layer"] != 9 * 101:
        raise AssertionError("tools (f): first_contact's report is not an import of every parameter and a failed "
                             "verdict with every target's tolerance")
    keep("tools_first_contact", counts)
    numbers["first_contact_s"] = sec
    return out, numbers


def drive_conditional_path(torch, data_dir):
    """Property conditioning from end to end at full width in float32, on
    the user path's QM9-layout files: the conditional model's training
    (with a sampling evaluation), the property classifier's, the
    conditional evaluation and the guided optimization, each through its
    CLI.  Every launch count is read around the call that makes it and held
    exactly against its formula -> (launches by path of the forward and
    backward kernels, numbers)."""
    import numpy as np

    from bio_diffusion_torch.cli import mol_gen_eval_conditional_qm9, mol_gen_eval_optimization_qm9
    from bio_diffusion_torch.cli import train, train_classifier
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train.loop import Trainer
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    root = os.path.join(REPO, "outputs", "conditional_path")
    shutil.rmtree(root, ignore_errors=True)
    data = [f"datamodule.dataloader_cfg.data_dir={data_dir}"]
    out, numbers = {"fwd": {}, "bwd": {}}, {}

    def run(fn):
        ml.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0, dict(ml.launch_counts)

    # (a) the conditional model's training, with a sampling evaluation
    with spy(torch, Trainer, "evaluate_sampling") as evals, spy(torch, SegmentedSampler, "run") as batches:
        trainer, sec, counts = run(lambda: train.main([
            "experiment=qm9_mol_gen_conditional_ddpm", *data, "datamodule.dataloader_cfg.batch_size=64",
            "trainer.precision=fp32", "trainer.check_val_every_n_epoch=1", "trainer.limit_train_batches=4",
            "trainer.limit_val_batches=2", "model.diffusion_cfg.sample_during_training=true",
            "model.diffusion_cfg.eval_epochs=1", "model.diffusion_cfg.num_eval_samples=16",
            "model.diffusion_cfg.eval_batch_size=16", "--device=cuda", "--max-epochs=1",
            f"--workdir={root}/train"]))
    exp, st = trainer.exp, trainer.stats
    layers, T = exp.model_cfg.num_encoder_layers, exp.diffusion_cfg.num_timesteps
    if (exp.module_cfg.conditioning, exp.dataloader_cfg.include_charges, exp.model_cfg.h_hidden_dim) \
            != (("alpha",), False, 256):
        raise AssertionError("the conditional run is not the full-width alpha model without charges")
    eval_launches = sum(c["launches"] for c in evals)
    measured = {"cond_train": counts["message_layer"] - eval_launches, "cond_sampling_eval": eval_launches}
    need = {"cond_train": layers * (st["micro_batches"] + 2 * st["eval_batches"]),
            "cond_sampling_eval": layers * (T + 1) * len(batches)}
    print(f"conditional train: {st['steps']} steps, {st['eval_batches']} EMA validation batches, one sampling "
          f"evaluation of {len(batches)} sampler batch(es) of 16 at T={T} with drawn alpha contexts, {sec:.3f} s "
          f"with set-up; launches fwd train {measured['cond_train']} (need {need['cond_train']}), sampling eval "
          f"{measured['cond_sampling_eval']} (need {need['cond_sampling_eval']}), bwd "
          f"{counts['message_layer_bwd']} (need {layers * st['micro_batches']})")
    if (st["steps"], len(evals), len(batches)) != (4, 1, 1) or measured != need \
            or counts["message_layer_bwd"] != layers * st["micro_batches"]:
        raise AssertionError("the conditional training run's launch counts are not exact")
    val = [r for r in trainer.loggers.loggers[0].rows if "val/mol_stable" in r]
    if not val or not np.isfinite(val[-1]["val/kl_div_atom_types"]):
        raise AssertionError("the conditional sampling evaluation logged no val/ metrics")
    out["fwd"].update(measured)
    out["bwd"]["cond_train"] = counts["message_layer_bwd"]
    numbers["train_s"] = sec

    # (b) the property classifier at the config's width
    result, sec, counts = run(lambda: train_classifier.main([
        "property=alpha", *data, "epochs=1", "device=cuda", f"output_dir={root}/classifier"]))
    if counts["message_layer"] or counts["message_layer_bwd"] or not np.isfinite(result["best_valid_mae"]):
        raise AssertionError(f"train_classifier: launches {counts}, result {result}")
    numbers["classifier_s"] = sec
    print(f"conditional train_classifier: one epoch (hidden 128, 7 layers, batch 96) {sec:.3f} s, best valid "
          f"MAE {result['best_valid_mae']:.6g} (printed, not judged), no message-layer launch")

    # (c) the conditional evaluation from (a)'s checkpoint and (b)'s classifier
    cli = [*data, f"classifier_model_dir={result['model_dir']}", "device=cuda", "precision=fp32"]
    with spy(torch, SegmentedSampler, "run") as batches:
        metrics, sec, counts = run(lambda: mol_gen_eval_conditional_qm9.main(cli + [
            f"generator_model_filepath={trainer.ckpt_dir}", "iterations=1", "batch_size=100",
            f"output_dir={root}/eval"]))
    if len(batches) != 1 or counts["message_layer"] != layers * (T + 1) or not np.isfinite(metrics["mae"]):
        raise AssertionError(f"mol_gen_eval_conditional_qm9 launched {counts['message_layer']} in {len(batches)} "
                             f"sampler batch(es), need {layers * (T + 1)} in one; MAE {metrics['mae']}")
    out["fwd"]["cond_eval_cli"] = counts["message_layer"]
    loop_s = batches[0]["s"]
    numbers.update(cond_sample_s_per_step=loop_s / T, cond_sample_mol_per_s=100 / loop_s, cond_eval_cli_s=sec)
    print(f"conditional mol_gen_eval_conditional_qm9: the sampler's batch of 100 (prior, T={T} reverse steps with "
          f"contexts, decode) took {loop_s:.3f} s = {loop_s / T:.6f} s per reverse step, {100 / loop_s:.3f} "
          f"molecules/s; the CLI call {sec:.3f} s with set-up; launches {counts['message_layer']}; classifier MAE "
          f"{metrics['mae']:.6g} (printed, not judged)")

    # (d) guided optimization: seed-weight starting molecules, then round trips
    opt_args = cli + [f"conditional_generator_model_filepath={trainer.ckpt_dir}", "num_samples=100",
                      "batch_size=100", "num_gen_timesteps=10", "num_optimization_timesteps=100", "iterations=2",
                      f"output_dir={root}/optimization"]
    with spy(torch, SegmentedSampler, "run") as gen, \
            spy(torch, EquivariantVariationalDiffusion, "mol_gen_optimize") as trips:
        result, sec, counts = run(lambda: mol_gen_eval_optimization_qm9.main(opt_args))
    measured = {"opt_generate": sum(c["launches"] for c in gen), "opt_optimize": sum(c["launches"] for c in trips)}
    if len(gen) != 1 or len(trips) != 2 or measured != {"opt_generate": layers * 11, "opt_optimize": 2 * layers * 101} \
            or counts["message_layer"] != sum(measured.values()) or counts["message_layer_bwd"]:
        raise AssertionError(f"the optimization CLI's launch counts are not exact: {measured}, {counts}")
    if [e["iteration"] for e in result["history"]] != [1, 2] \
            or not all(np.isfinite(e["mol_stable"]) for e in result["history"]):
        raise AssertionError(f"optimization history: {result['history']}")
    out["fwd"].update(measured)
    numbers.update(opt_cli_s=sec, opt_round_trip_s=[c["s"] for c in trips])
    print(f"conditional mol_gen_eval_optimization_qm9: 100 molecules in 10 steps, 2 round trips of 100 steps, "
          f"{sec:.3f} s with set-up (round trips {', '.join('%.3f' % c['s'] for c in trips)} s); launches "
          f"{measured}; history (printed, not judged) {result['history']}")
    return out, numbers


GEOM_BUCKETS = (48, 64, 96, 128, 192)
# the kernel's chunks against its whole batch, float32: weight grads
# relative to max|whole| of each (the chunk sums add in another order)
TOL_CHUNK_REL = 1e-5
# the backward's outputs the kernel writes per molecule (or the wrapper
# forms from those): bit-identical however the batch is cut
PER_MOLECULE = ("d_s_node", "d_v_node", "d_epack", "d_g1[wsi]", "d_g1[wsj]", "d_g1[wvi]", "d_g1[wvj]")


def geom_experiment(precision: str, extra=()):
    from bio_diffusion_torch.config.build import build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config

    return build_experiment(load_config(default_config_dir(), "train", [
        "experiment=geom_mol_gen_ddpm", f"trainer.precision={precision}", *extra]))


def check_geom_kernels(torch, evd):
    """B1 and B2 at full GEOM width (S=256, V=32, Se=16, Ve=8, H1=18, 4
    message GCPs), float32 and bfloat16: each against its plain version up
    to N=181 (padded rows), B1 timed beside its plain version at B=16, N=96,
    the backward's chunks of molecules against its whole batch, and one
    full-width backward at B=64, N=96 in the chunks the wrapper picks, its
    launches (one a chunk) held against the wrapper's plan -> (forward
    block, backward block) of the kernels line, and the kernel's floats of
    scratch an edge row at GEOM width."""
    from bio_diffusion_torch.ops import message_layer as ml

    fwd, bwd = {"errors": {}, "by_shape": {}}, {"errors": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, n, padded in ((8, 48, False), (4, 96, False), (2, 181, True)):
            args, ve = kernel_inputs(torch, evd, b, n, dtype, padded, seed=b * 1000 + n + 7)
            label = f"GEOM B={b} N={n} padded={padded}"
            fwd["errors"][f"{name} B={b} N={n}"] = compare_fwd(torch, args, ve, name, label)
            if n > 48:
                ct = cotangents(torch, args, seed=n + 3)
                bwd["errors"][f"{name} B={b} N={n}"] = compare_bwd(torch, args, ct, ve, name, label)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        args, ve = kernel_inputs(torch, evd, 16, 96, dtype, False, seed=9)
        kernel_ms, plain_ms, runs = in_turns(torch, lambda: ml.fused_message_layer(*args, ve_dim=ve),
                                             lambda: ml.message_layer_plain(*args, ve_dim=ve), reps=10)
        bound_ms, bound_by = bound(layer_flops(args, ve), nbytes(args, ml.fused_message_layer(*args, ve_dim=ve)),
                                   name)
        print(f"timing GEOM {name} B=16 N=96: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}) (runs {runs})")
        fwd["by_shape"][f"{name}, B=16, N=96"] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                                      bound_by=bound_by)
    # the backward beside its plain version at B=4, N=96, float32
    args, ve = kernel_inputs(torch, evd, 4, 96, torch.float32, False, seed=11)
    ct = cotangents(torch, args, seed=12)
    kernel_ms, plain_ms, runs = in_turns(torch, lambda: ml.fused_message_layer_bwd(*args, ct, ve_dim=ve),
                                         lambda: ml.message_layer_bwd_plain(*args, ct, ve_dim=ve), reps=5)
    out = ml.fused_message_layer_bwd(*args, ct, ve_dim=ve)
    bound_ms, bound_by = bound(3 * layer_flops(args, ve), nbytes(args, ct, out), "float32")
    bwd["by_shape"] = {"float32, B=4, N=96": dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                                   bound_by=bound_by)}
    print(f"timing GEOM bwd float32 B=4 N=96: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}) (runs {runs})")

    # chunks of molecules against the whole batch, at a size where both fit
    args, ve = kernel_inputs(torch, evd, 16, 96, torch.float32, True, seed=16)
    ct = cotangents(torch, args, seed=17)
    whole = ml.bwd_outputs(ml._message_layer_bwd_cuda(*args, ct, ve, chunk_molecules=16))
    runs = [ml.bwd_outputs(ml._message_layer_bwd_cuda(*args, ct, ve, chunk_molecules=4)) for _ in range(2)]
    torch.cuda.synchronize()
    worst = 0.0
    for (part, a), (_, a2), (_, w) in zip(*runs, whole):
        if not torch.equal(a, a2):
            raise AssertionError(f"chunked backward: two runs differ in {part}")
        if part in PER_MOLECULE:
            if not torch.equal(a, w):
                raise AssertionError(f"chunked backward: {part} differs from the whole batch's")
        else:
            rel = (a - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            if rel > TOL_CHUNK_REL:
                raise AssertionError(f"chunked backward: {part} off the whole batch's by {rel:.3g} of max")
            worst = max(worst, rel)
    bwd["chunks_vs_whole"] = {"shape": "float32, B=16, N=96, 4 chunks of 4", "weight_grad_max_rel": worst}
    print(f"chunked bwd GEOM float32 B=16 N=96, 4 chunks of 4 vs one: {', '.join(PER_MOLECULE)} "
          f"bit-identical; weight grads within {worst:.3g} of max (tol {TOL_CHUNK_REL:g}); two chunked "
          f"runs bit-identical: ok")
    del args, ct, whole, runs

    # the two reductions alone at the largest chunk of the wrapper's plan
    # (4 molecules at N=192)
    args, ve = kernel_inputs(torch, evd, 4, 192, torch.float32, True, seed=192)
    bwd["reductions_alone"] = {"B=4, N=192": check_bwd_reductions(torch, args, ve, "GEOM B=4 N=192")}
    del args

    # one full-width backward at B=64, N=96 in the wrapper's own chunks
    args, ve = kernel_inputs(torch, evd, 64, 96, torch.float32, True, seed=64)
    ct = cotangents(torch, args, seed=65)
    chunk, chunks, mol_bytes = ml.bwd_chunks(*args, ve_dim=ve)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ml.reset_launch_counts()
    out = ml.fused_message_layer_bwd(*args, ct, ve_dim=ve)
    walked = ml.launch_counts["message_layer_bwd"]
    if walked != chunks:
        raise AssertionError(f"the B=64, N=96 backward launched its kernel {walked} times; the plan is {chunks} "
                             f"chunks of up to {chunk} molecules")
    ms = time_ms(torch, lambda: ml.fused_message_layer_bwd(*args, ct, ve_dim=ve), reps=3)
    peak = torch.cuda.max_memory_allocated()
    bound_ms, bound_by = bound(3 * layer_flops(args, ve), nbytes(args, ct, out), "float32")
    bwd["b64_n96"] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by, chunks=walked,
                          peak_bytes_above_inputs=peak - base, peak_bytes=peak)
    print(f"timing GEOM bwd float32 B=64 N=96: {ms:.4f} ms; one backward launched the kernel {walked} times "
          f"(plan: {chunks} chunks of up to {chunk} molecules, scratch {mol_bytes / 2**20:.1f} MiB a molecule); "
          f"bound {bound_ms:.4f} ms ({bound_by}); peak device memory {peak / 2**30:.3f} GiB, "
          f"{(peak - base) / 2**30:.3f} GiB above the inputs")
    return fwd, bwd, mol_bytes // (4 * 96 * 96)


def bwd_plan_chunks(ml, row_floats, b, n):
    """Chunks of the backward wrapper's plan for ``b`` molecules padded to
    ``n`` at ``row_floats`` floats of scratch an edge row."""
    return -(-b // min(b, ml.bwd_chunk_molecules(n, row_floats)))


@contextlib.contextmanager
def step_batches():
    """Record the padded shape and largest molecule of every batch the
    Trainers built in the block train or validate on, and the backward
    kernel's launches of each train step."""
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train import loop

    seen = {"train": [], "valid": [], "train_bwd": []}
    orig = {"train": loop.make_train_step, "valid": loop.make_eval_step}

    def wrap(make, key):
        def made(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(*a, **k):
                batch = a[1] if key == "train" else a[0]
                seen[key].append((tuple(batch.node_mask.shape), int(batch.node_mask.sum(1).max())))
                before = ml.launch_counts["message_layer_bwd"]
                result = step(*a, **k)
                if key == "train":
                    seen["train_bwd"].append(ml.launch_counts["message_layer_bwd"] - before)
                return result
            return run
        return made

    loop.make_train_step, loop.make_eval_step = wrap(orig["train"], "train"), wrap(orig["valid"], "valid")
    try:
        yield seen
    finally:
        loop.make_train_step, loop.make_eval_step = orig["train"], orig["valid"]


def geom_worst_step(torch, data_dir, root, row_floats):
    """Trainer steps of the full-width GEOM model (fp32) on the worst batch
    the config admits: B=64 padded to the 192 bucket, its largest molecule
    181 atoms (one drawn from the seed beside the 63 largest of the train
    split); the backward's launches held against the wrapper's plan at the
    kernel's ``row_floats`` -> numbers."""
    import numpy as np

    from bio_diffusion_torch.data.batch import iterate_dense_batches
    from bio_diffusion_torch.data.geom import _to_dense, load_split_data
    from bio_diffusion_torch.data.synthetic import geom_like_conformers
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train.loop import Trainer

    exp = geom_experiment("fp32", [f"datamodule.dataloader_cfg.data_dir={data_dir}"])
    trainer = Trainer(exp, os.path.join(root, "worst"), "cuda")
    trainer.init_state(resume=False)
    layers = exp.model_cfg.num_encoder_layers
    train = load_split_data(os.path.join(data_dir, "GEOM", "GEOM_drugs_30.npy"))["train"]
    mols = geom_like_conformers([181], np.random.default_rng(181)) + sorted(train, key=len)[-63:]
    batch = next(iterate_dense_batches(_to_dense(mols, remove_h=False), 64, shuffle=False,
                                       bucket_sizes=exp.dataloader_cfg.bucket_sizes)).to("cuda")
    if tuple(batch.node_mask.shape) != (64, 192) or int(batch.node_mask.sum(1).max()) != 181:
        raise AssertionError(f"the worst batch is {tuple(batch.node_mask.shape)}, not B=64 padded to 192")
    total = torch.cuda.get_device_properties(0).total_memory
    plan = bwd_plan_chunks(ml, row_floats, 64, 192)
    out = {"shape": "fp32, B=64, N=192 (largest molecule 181 atoms)", "steps_ms": [], "total_bytes": total}
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ml.reset_launch_counts()
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_ev.record()
        metrics = trainer.train_step(trainer.state, batch, trainer.generator)
        end_ev.record()
        torch.cuda.synchronize()
        loss = float(metrics["loss"])
        counts = dict(ml.launch_counts)
        if not np.isfinite(loss) or (counts["message_layer"], counts["message_layer_bwd"]) != (layers, layers * plan):
            raise AssertionError(f"worst GEOM step: loss {loss}, launches {counts}, need {layers} forward and "
                                 f"{layers} x {plan} backward chunks")
        out["steps_ms"].append(start_ev.elapsed_time(end_ev))
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out.update(fwd_launches=counts["message_layer"], bwd_launches=counts["message_layer_bwd"],
               bwd_chunks_per_layer=counts["message_layer_bwd"] // layers)
    print(f"GEOM worst batch: Trainer steps at B=64, N=192 (largest 181 atoms), fp32: "
          f"{', '.join('%.3f' % t for t in out['steps_ms'])} ms, loss {loss:.6g} (finite), launches fwd "
          f"{counts['message_layer']} bwd {counts['message_layer_bwd']} = {layers} layers x "
          f"{out['bwd_chunks_per_layer']} chunks (plan: {plan} chunks of up to "
          f"{ml.bwd_chunk_molecules(192, row_floats)} molecules at {row_floats} floats of scratch an edge row); "
          f"peak device memory {out['peak_bytes'] / 2**30:.3f} GiB of {total / 2**30:.3f} GiB")
    del trainer, batch
    return out


def drive_geom_path(torch):
    """GEOM-Drugs at full width (4 layers, S=256, V=32, Se=16, Ve=8) in
    float32: GEOM-layout files written from a seed (1,280 conformers, sizes
    drawn from GEOM-Drugs' histogram) under ``outputs/geom_path``; B1 and B2
    at GEOM width against their plain versions and timed, the backward's
    chunks against its whole batch; Trainer steps on the worst batch the
    config admits (B=64 padded to 192); ``cli.train.main`` (batch 64 in its
    buckets, 4 train batches, 2 EMA validation batches, a sampling evaluation
    of 16 at T=1000); ``cli.mol_gen_sample.main`` and ``cli.mol_gen_eval.main``
    (16 molecules each, sizes drawn, T=1000; one NLL pass over the 2 test
    batches) from the checkpoint directory.  Every launch count is read
    around the call that makes it and held exactly -> (launches by path of
    the forward and backward kernels, forward block, backward block)."""
    import numpy as np

    from bio_diffusion_torch.cli import mol_gen_eval, mol_gen_sample, train
    from bio_diffusion_torch.cli.common import load_model
    from bio_diffusion_torch.data.batch import select_bucket
    from bio_diffusion_torch.data.dataset_info import GEOM_WITH_H
    from bio_diffusion_torch.data.synthetic import write_geom_layout
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train.loop import Trainer
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    root = os.path.join(REPO, "outputs", "geom_path")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = os.path.join(root, "data")
    t0 = time.perf_counter()
    write_geom_layout(data_dir, num_conformers=1280, seed=0)
    print(f"GEOM path: GEOM-layout files (1,280 conformers with H, sizes from GEOM-Drugs' histogram) written "
          f"in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    evd = load_model(geom_experiment("fp32"), None, torch.device("cuda"), seed=0)
    fwd_block, bwd_block, row_floats = check_geom_kernels(torch, evd)
    del evd
    torch.cuda.empty_cache()
    print(f"GEOM path kernel checks: {time.perf_counter() - t0:.3f} s")
    worst = geom_worst_step(torch, data_dir, root, row_floats)
    torch.cuda.empty_cache()
    fwd_block["worst_step"] = worst
    bwd_block["worst_step"] = {k: worst[k] for k in ("bwd_launches", "bwd_chunks_per_layer")}

    out, numbers = {"fwd": {}, "bwd": {}}, {}

    def run(fn):
        ml.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0, dict(ml.launch_counts)

    args = ["experiment=geom_mol_gen_ddpm", f"datamodule.dataloader_cfg.data_dir={data_dir}",
            "trainer.precision=fp32", "trainer.check_val_every_n_epoch=1", "trainer.limit_train_batches=4",
            "trainer.limit_val_batches=2", "model.diffusion_cfg.sample_during_training=true",
            "model.diffusion_cfg.eval_epochs=1", "model.diffusion_cfg.num_eval_samples=16",
            "model.diffusion_cfg.eval_batch_size=16", "--device=cuda", "--max-epochs=1", f"--workdir={root}/train"]
    with spy(torch, Trainer, "evaluate_sampling") as evals, spy(torch, SegmentedSampler, "run") as batches, \
            step_batches() as seen:
        trainer, sec, counts = run(lambda: train.main(args))
    exp, st = trainer.exp, trainer.stats
    layers, T = exp.model_cfg.num_encoder_layers, exp.diffusion_cfg.num_timesteps
    dl, mc = exp.dataloader_cfg, exp.model_cfg
    if (layers, mc.h_hidden_dim, mc.chi_hidden_dim, mc.e_hidden_dim, mc.xi_hidden_dim, dl.batch_size,
            tuple(dl.bucket_sizes), T) != (4, 256, 32, 16, 8, 64, GEOM_BUCKETS, 1000):
        raise AssertionError("the GEOM run is not the published configuration")
    eval_launches = sum(c["launches"] for c in evals)
    measured = {"geom_train": counts["message_layer"] - eval_launches, "geom_sampling_eval": eval_launches}
    need = {"geom_train": layers * (st["micro_batches"] + 2 * st["eval_batches"]),
            "geom_sampling_eval": layers * (T + 1) * len(batches)}
    buckets_ok = all(shape[1] == select_bucket(largest, GEOM_BUCKETS) for split in ("train", "valid")
                     for shape, largest in seen[split])
    bwd_need = [layers * bwd_plan_chunks(ml, row_floats, *shape) for shape, _ in seen["train"]]
    print(f"GEOM train: {st['steps']} steps, {st['eval_batches']} EMA validation batches, one sampling evaluation "
          f"of {len(batches)} sampler batch(es) of 16 at T={T}, {sec:.3f} s with set-up; train batches (B, padded N; "
          f"largest) {seen['train']}, validation batches {seen['valid']}; launches fwd train {measured['geom_train']} "
          f"(need {need['geom_train']}), sampling eval {measured['geom_sampling_eval']} (need "
          f"{need['geom_sampling_eval']}), bwd {counts['message_layer_bwd']} by train batch {seen['train_bwd']} "
          f"(need layers x planned chunks: {bwd_need})")
    if (st["steps"], st["eval_batches"], len(evals), len(batches)) != (4, 2, 1, 1) or measured != need \
            or seen["train_bwd"] != bwd_need or counts["message_layer_bwd"] != sum(bwd_need) or not buckets_ok \
            or len(seen["train"]) != 4 or any(shape[0] != 64 for shape, _ in seen["train"]):
        raise AssertionError("the GEOM training run's batches or launch counts are not exact")
    val = [r for r in trainer.loggers.loggers[0].rows if "val/mol_stable" in r]
    losses = [r["train/loss"] for r in trainer.loggers.loggers[0].rows if "train/loss" in r]
    if not val or not np.isfinite(val[-1]["val/kl_div_atom_types"]) or not np.all(np.isfinite(losses)):
        raise AssertionError("the GEOM run logged a non-finite loss or no val/ metrics")
    out["fwd"].update(measured)
    out["bwd"]["geom_train"] = counts["message_layer_bwd"]
    numbers.update(train_s=sec, train_batches=seen["train"], valid_batches=seen["valid"],
                   train_bwd_launches=seen["train_bwd"],
                   train_sampling_eval={"n": batches[0]["shape"][1], "s_per_step": batches[0]["s"] / T})

    info = GEOM_WITH_H
    cli = ["experiment=geom_mol_gen_ddpm", f"ckpt_path={trainer.ckpt_dir}", "device=cuda", "precision=fp32",
           "num_samples=16", "sampling_batch_size=16"]
    with spy(torch, SegmentedSampler, "run") as batches:
        metrics, sec, counts = run(lambda: mol_gen_sample.main(cli + [f"output_dir={root}/samples"]))
    mols = xyz_molecules(os.path.join(root, "samples"), info)
    check_molecules(mols, 16)
    if len(batches) != 1 or counts["message_layer"] != layers * (T + 1) or counts["message_layer_bwd"]:
        raise AssertionError(f"GEOM mol_gen_sample launched {counts} in {len(batches)} sampler batch(es), need "
                             f"{layers * (T + 1)} forward in one")
    out["fwd"]["geom_sample_cli"] = counts["message_layer"]
    b = batches[0]
    numbers["sample"] = {"n": b["shape"][1], "s": b["s"], "s_per_step": b["s"] / T, "mol_per_s": 16 / b["s"],
                         "cli_s": sec}
    print(f"GEOM mol_gen_sample: 16 xyz files (sizes {sorted(m['size'] for m in mols)}, elements "
          f"{sorted({a for m in mols for a in m['atoms']})}), molecules pass the checks; the sampler's batch of 16 "
          f"padded to N={b['shape'][1]} took {b['s']:.3f} s = {b['s'] / T:.6f} s per reverse step, "
          f"{16 / b['s']:.3f} molecules/s; the CLI {sec:.3f} s with set-up; launches {counts['message_layer']}; "
          f"metrics (printed, not judged) {metrics}")

    with spy(torch, SegmentedSampler, "run") as batches:
        metrics, sec, counts = run(lambda: mol_gen_eval.main(cli + [
            "num_test_passes=1", f"datamodule.dataloader_cfg.data_dir={data_dir}", f"output_dir={root}/eval"]))
    with open(os.path.join(root, "eval", "eval_results.json")) as f:
        saved = json.load(f)
    test_batches = -(-len(trainer.datasets["test"]) // 64)
    sampled = sum(c["launches"] for c in batches)
    if not np.isfinite(saved.get("test_nll", float("nan"))) or saved != metrics or test_batches != 2:
        raise AssertionError(f"GEOM eval_results.json: {saved} ({test_batches} test batches)")
    if len(batches) != 1 or sampled != layers * (T + 1) \
            or counts["message_layer"] - sampled != layers * 2 * test_batches:
        raise AssertionError(f"GEOM mol_gen_eval launched {sampled} in {len(batches)} sampler batch(es) and "
                             f"{counts['message_layer'] - sampled} for the NLL (need {layers * (T + 1)} and "
                             f"{layers * 2 * test_batches})")
    out["fwd"]["geom_eval_cli"] = counts["message_layer"]
    b = batches[0]
    numbers["eval"] = {"n": b["shape"][1], "s": b["s"], "s_per_step": b["s"] / T, "mol_per_s": 16 / b["s"],
                       "cli_s": sec}
    print(f"GEOM mol_gen_eval: the sampler's batch of 16 padded to N={b['shape'][1]} took {b['s']:.3f} s = "
          f"{b['s'] / T:.6f} s per reverse step, {16 / b['s']:.3f} molecules/s; the CLI {sec:.3f} s with set-up "
          f"(one NLL pass over {test_batches} test batches); test_nll {saved['test_nll']:.6g} (finite), launches "
          f"{counts['message_layer']}; metrics (printed, not judged) {saved}")
    fwd_block["path"] = numbers
    return out, fwd_block, bwd_block


POCKET_BUCKETS = (48, 64, 96, 128, 144)
# the backward's chunks a B=32 pocket micro-batch in each bucket, by the
# wrapper's plan at the GEOM width's 6,040 floats of scratch an edge row
POCKET_PLAN = {48: 1, 64: 1, 96: 2, 128: 4, 144: 4}


def pocket_experiment(precision: str, extra=()):
    from bio_diffusion_torch.config.build import build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config

    return build_experiment(load_config(default_config_dir(), "train", [
        "experiment=pocket_mol_gen_ddpm", f"trainer.precision={precision}", *extra]))


def check_pocket_kernels(torch, evd):
    """B1 and B2 at the pocket training shape, float32, with the pocket
    model's layer-0 weights (the GEOM widths): B1 against its plain version
    at B=32, N=144 with padded rows, timed in turns; B2 against its plain
    version at B=2, N=144; B2 at B=32, N=144 in the wrapper's own chunks
    (launches held against the plan) against one whole-batch call, the
    per-molecule outputs bit-identical, and timed -> (numbers, the kernel's
    floats of scratch an edge row)."""
    from bio_diffusion_torch.ops import message_layer as ml

    out = {}
    args, ve = kernel_inputs(torch, evd, 32, 144, torch.float32, True, seed=144)
    out["fwd_max_rel_err"] = compare_fwd(torch, args, ve, "float32", "pocket B=32 N=144 padded=True")
    kernel_ms, plain_ms, runs = in_turns(torch, lambda: ml.fused_message_layer(*args, ve_dim=ve),
                                         lambda: ml.message_layer_plain(*args, ve_dim=ve), reps=5)
    bound_ms, bound_by = bound(layer_flops(args, ve), nbytes(args, ml.fused_message_layer(*args, ve_dim=ve)),
                               "float32")
    out["fwd_b32_n144"] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    print(f"timing pocket fwd float32 B=32 N=144: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}) (runs {runs})")

    small, ve = kernel_inputs(torch, evd, 2, 144, torch.float32, True, seed=145)
    out["bwd_max_rel_err"] = compare_bwd(torch, small, cotangents(torch, small, seed=146), ve, "float32",
                                         "pocket B=2 N=144 padded=True")
    del small

    ct = cotangents(torch, args, seed=147)
    chunk, chunks, mol_bytes = ml.bwd_chunks(*args, ve_dim=ve)
    row_floats = mol_bytes // (4 * 144 * 144)
    if (chunk, chunks) != (32 // POCKET_PLAN[144], POCKET_PLAN[144]):
        raise AssertionError(f"the pocket backward's plan at B=32, N=144 is {chunks} chunks of {chunk}")
    ml.reset_launch_counts()
    chunked = ml.bwd_outputs(ml.fused_message_layer_bwd(*args, ct, ve_dim=ve))
    walked = ml.launch_counts["message_layer_bwd"]
    whole = ml.bwd_outputs(ml._message_layer_bwd_cuda(*args, ct, ve, chunk_molecules=32))
    torch.cuda.synchronize()
    if walked != chunks:
        raise AssertionError(f"the pocket backward launched its kernel {walked} times; the plan is {chunks}")
    worst = 0.0
    for (part, a), (_, w) in zip(chunked, whole):
        if part in PER_MOLECULE:
            if not torch.equal(a, w):
                raise AssertionError(f"pocket chunked backward: {part} differs from the whole batch's")
        else:
            rel = (a - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            if rel > TOL_CHUNK_REL:
                raise AssertionError(f"pocket chunked backward: {part} off the whole batch's by {rel:.3g} of max")
            worst = max(worst, rel)
    del whole, chunked
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, lambda: ml.fused_message_layer_bwd(*args, ct, ve_dim=ve), reps=3)
    peak = torch.cuda.max_memory_allocated()
    bound_ms, bound_by = bound(3 * layer_flops(args, ve), nbytes(args, ct, ml.fused_message_layer_bwd(
        *args, ct, ve_dim=ve)), "float32")
    out["bwd_b32_n144"] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by, chunks=walked,
                               weight_grad_max_rel=worst, peak_bytes_above_inputs=peak - base)
    print(f"pocket bwd float32 B=32 N=144: {walked} launches (plan: {chunks} chunks of {chunk} molecules at "
          f"{row_floats} floats of scratch an edge row) against one whole-batch call: {', '.join(PER_MOLECULE)} "
          f"bit-identical, weight grads within {worst:.3g} of max (tol {TOL_CHUNK_REL:g}); {ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); peak {(peak - base) / 2**30:.3f} GiB above the inputs")
    return out, row_floats


def pocket_largest_step(torch, trainer, layers):
    """Two Trainer steps (fp32, after its run) on the 32 largest joint
    graphs of the train split, padded to their bucket: CUDA events, launches
    held against the plan, peak memory -> numbers."""
    import numpy as np

    from bio_diffusion_torch.data.batch import DenseDataset, iterate_dense_batches
    from bio_diffusion_torch.ops import message_layer as ml

    ds = trainer.datasets["train"]
    idx = np.argsort(ds.data["num_atoms"], kind="stable")[-32:]
    sub = DenseDataset({k: v[idx] for k, v in ds.data.items()}, ds.included_species)
    batch = next(iterate_dense_batches(sub, 32, shuffle=False, drop_last=False,
                                       bucket_sizes=POCKET_BUCKETS)).to("cuda")
    (b, n), largest = batch.node_mask.shape, int(batch.node_mask.sum(1).max())
    if b != 32:
        raise AssertionError(f"the pocket train split has {b} graphs, not 32 or more")
    out = {"shape": f"fp32, B=32, N={n} (largest graph {largest} nodes)", "steps_ms": []}
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ml.reset_launch_counts()
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_ev.record()
        loss = float(trainer.train_step(trainer.state, batch, trainer.generator)["loss"])
        end_ev.record()
        torch.cuda.synchronize()
        counts = (ml.launch_counts["message_layer"], ml.launch_counts["message_layer_bwd"])
        if not np.isfinite(loss) or counts != (layers, layers * POCKET_PLAN[n]):
            raise AssertionError(f"pocket step at N={n}: loss {loss}, launches {counts}, need {layers} forward "
                                 f"and {layers} x {POCKET_PLAN[n]} backward")
        out["steps_ms"].append(start_ev.elapsed_time(end_ev))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"pocket Trainer steps on the 32 largest train graphs (B=32, N={n}, largest {largest}), fp32: "
          f"{', '.join('%.3f' % t for t in out['steps_ms'])} ms, loss {loss:.6g} (finite), launches fwd "
          f"{counts[0]} bwd {counts[1]} ({layers} layers x {POCKET_PLAN[n]} chunks); peak device memory "
          f"{out['peak_bytes'] / 2**30:.3f} GiB")
    return out


def write_pocket_pdb(path, seed=0):
    """A PDB file of 40 CA residues of chain A on a shell of radius ~6.5 A
    around a 4-atom HETATM ligand ``LIG``, one chain-B residue 30 A away,
    one alternate location B of residue 1 (both must be left out) ->
    (the 40 coordinates as written, the residue names)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    names = ["ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE", "LEU", "LYS", "MET", "PHE",
             "PRO", "SER", "THR", "TRP", "TYR", "VAL"]
    center = np.array([12.0, -4.0, 7.0])
    dirs = rng.normal(size=(40, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    coords = np.round(center + dirs * (6.5 + 0.4 * rng.uniform(-1, 1, size=(40, 1))), 3)
    residues = [names[i % 20] for i in range(40)]

    def line(serial, rec, name, altloc, resname, chain, resseq, xyz):
        return (f"{rec:<6}{serial:>5} {name:<4}{altloc}{resname:<3} {chain}{resseq:>4}    "
                f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00")

    lines = ["HEADER    SMOKE POCKET"]
    for i, (xyz, res) in enumerate(zip(coords, residues)):
        lines.append(line(i + 1, "ATOM", " CA ", " ", res, "A", i + 1, xyz))
    lines.append(line(41, "ATOM", " CA ", "B", residues[0], "A", 1, coords[0] + 0.5))
    lines.append(line(42, "ATOM", " CA ", " ", "VAL", "B", 1, center + 30.0))
    for i in range(4):
        lines.append(line(43 + i, "HETATM", " C  ", " ", "LIG", "A", 99, center + 0.4 * (i - 1.5)))
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return coords.astype(np.float32), residues


def check_pocket_samples(call, num_samples, kl, run_dir):
    """One ``generate_ligands_in_pocket`` call of the sample CLI: finite
    ligands, one ligand type a real atom, the pocket rows of ``joint_xh``
    the input's bit for bit, ``pockets.json`` the input pockets."""
    import numpy as np

    pocket_x, pocket_aa, pocket_mask = call["args"][2:5]
    out = call["result"]
    nl = out["ligand_mask"].shape[1]
    joint = out["joint_xh"]
    kp = joint.shape[-1] - 3 - kl
    if len(joint) != num_samples or not np.isfinite(joint).all():
        raise AssertionError(f"pocket samples: {len(joint)} graphs, finite {np.isfinite(joint).all()}")
    if not np.array_equal(out["ligand_one_hot"].sum(-1), out["ligand_mask"]):
        raise AssertionError("pocket samples: not one ligand type a real ligand atom")
    if not np.array_equal(joint[:, nl:, :3], pocket_x * pocket_mask[..., None]) or not np.array_equal(
            joint[:, nl:, 3 + kl:], np.eye(kp, dtype=np.float32)[pocket_aa] * pocket_mask[..., None]):
        raise AssertionError("pocket samples: the pocket rows of joint_xh differ from the input")
    with open(os.path.join(run_dir, "pockets.json")) as f:
        saved = json.load(f)
    if not np.array_equal(np.asarray(saved["coords"], np.float32), pocket_x) \
            or saved["residue_index"] != pocket_aa.tolist():
        raise AssertionError("pockets.json does not hold the input pockets")
    return nl, joint.shape[1]


def drive_pocket_path(torch):
    """Pocket-conditional generation at the ``pocket_mol_gen_ddpm`` width
    (4 layers, S=256, V=32, Se=16, Ve=8; 30 atom types, no charge channel;
    batch 32 in the buckets [48, 64, 96, 128, 144]) in float32, weights
    drawn from a seed: B1 and B2 at the pocket training shape; (a)
    ``cli.train.main`` on the synthetic joint graphs (4 train batches, 2 EMA
    validation batches, no sampling evaluation) and 2 timed Trainer steps
    on its 32 largest graphs; (b) ``cli.mol_gen_sample.main`` with
    ``ddpm_mode=pocket`` from (a)'s checkpoint into 8 synthetic pockets at
    T=1000; (c) the same into the binding site of a PDB file the smoke
    writes, T=100 with 2 resamplings and jumps of 10; (d) the QM9
    ``inpainting`` mode, 8 molecules of 19 atoms at T=1000.  Every launch
    count is read around the call that makes it and held exactly -> (launches
    by path of the forward and backward kernels, numbers)."""
    import numpy as np

    from bio_diffusion_torch.cli import mol_gen_sample, train
    from bio_diffusion_torch.cli.common import load_model
    from bio_diffusion_torch.data.batch import select_bucket
    from bio_diffusion_torch.data.pocket import load_pocket_pdb
    from bio_diffusion_torch.ops import message_layer as ml

    root = os.path.join(REPO, "outputs", "pocket_path")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    evd = load_model(pocket_experiment("fp32"), None, torch.device("cuda"), seed=0)
    numbers, row_floats = check_pocket_kernels(torch, evd)
    del evd
    torch.cuda.empty_cache()
    print(f"pocket path kernel checks: {time.perf_counter() - t0:.3f} s")
    plan = {n: bwd_plan_chunks(ml, row_floats, 32, n) for n in POCKET_BUCKETS}
    if plan != POCKET_PLAN:
        raise AssertionError(f"the backward's plan by bucket at B=32 is {plan}, not {POCKET_PLAN}")
    out = {"fwd": {}, "bwd": {}}

    def run(fn):
        ml.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0, dict(ml.launch_counts)

    # (a) the joint model's training on synthetic joint graphs
    args = ["experiment=pocket_mol_gen_ddpm", "trainer.precision=fp32", "trainer.check_val_every_n_epoch=1",
            "trainer.limit_train_batches=4", "trainer.limit_val_batches=2",
            "model.diffusion_cfg.sample_during_training=false", "--device=cuda", "--max-epochs=1",
            f"--workdir={root}/train"]
    torch.cuda.reset_peak_memory_stats()
    with step_batches() as seen:
        trainer, sec, counts = run(lambda: train.main(args))
    peak = torch.cuda.max_memory_allocated()
    exp, st = trainer.exp, trainer.stats
    layers, T = exp.model_cfg.num_encoder_layers, exp.diffusion_cfg.num_timesteps
    dl, mc = exp.dataloader_cfg, exp.model_cfg
    if (layers, mc.h_hidden_dim, mc.chi_hidden_dim, mc.e_hidden_dim, mc.xi_hidden_dim, dl.batch_size,
            tuple(dl.bucket_sizes), dl.num_atom_types, dl.include_charges, T) \
            != (4, 256, 32, 16, 8, 32, POCKET_BUCKETS, 30, False, 1000):
        raise AssertionError("the pocket run is not the pocket_mol_gen_ddpm configuration")
    need_fwd = layers * (st["micro_batches"] + 2 * st["eval_batches"])
    bwd_need = [layers * POCKET_PLAN[shape[1]] for shape, _ in seen["train"]]
    buckets_ok = all(shape[1] == select_bucket(largest, POCKET_BUCKETS) for split in ("train", "valid")
                     for shape, largest in seen[split])
    print(f"pocket train: {st['steps']} steps, {st['eval_batches']} EMA validation batches, {sec:.3f} s with "
          f"set-up; train batches (B, padded N; largest) {seen['train']}, validation batches {seen['valid']}; "
          f"launches fwd {counts['message_layer']} (need {need_fwd}), bwd {counts['message_layer_bwd']} by train "
          f"batch {seen['train_bwd']} (need layers x planned chunks: {bwd_need}); peak device memory "
          f"{peak / 2**30:.3f} GiB")
    if (st["steps"], st["eval_batches"]) != (4, 2) or counts["message_layer"] != need_fwd \
            or seen["train_bwd"] != bwd_need or counts["message_layer_bwd"] != sum(bwd_need) or not buckets_ok \
            or len(seen["train"]) != 4 or any(shape[0] != 32 for shape, _ in seen["train"]):
        raise AssertionError("the pocket training run's batches or launch counts are not exact")
    losses = [r["train/loss"] for r in trainer.loggers.loggers[0].rows if "train/loss" in r]
    if not losses or not np.all(np.isfinite(losses)):
        raise AssertionError("the pocket run logged a non-finite loss")
    out["fwd"]["pocket_train"] = counts["message_layer"]
    out["bwd"]["pocket_train"] = counts["message_layer_bwd"]
    # copies: the trainer's step stays wrapped, so the steps below record too
    numbers.update(train_s=sec, train_batches=list(seen["train"]), valid_batches=list(seen["valid"]),
                   train_bwd_launches=list(seen["train_bwd"]), train_peak_bytes=peak)
    ckpt = trainer.ckpt_dir
    numbers["largest_step"] = pocket_largest_step(torch, trainer, layers)
    del trainer
    torch.cuda.empty_cache()

    # (b) ligands into 8 synthetic pockets from (a)'s checkpoint, T=1000
    cli = ["experiment=pocket_mol_gen_ddpm", f"ckpt_path={ckpt}", "device=cuda", "precision=fp32",
           "ddpm_mode=pocket", "num_samples=8"]
    with spy(torch, mol_gen_sample, "generate_ligands_in_pocket") as calls:
        metrics, sec, counts = run(lambda: mol_gen_sample.main(cli + [
            "num_resamplings=1", "jump_length=1", f"output_dir={root}/synthetic"]))
    if len(calls) != 1 or counts["message_layer"] != layers * (T + 1) or calls[0]["launches"] != layers * (T + 1):
        raise AssertionError(f"pocket sampling launched {counts} in {len(calls)} call(s), need {layers * (T + 1)}")
    run_dir = os.path.join(root, "synthetic", os.listdir(os.path.join(root, "synthetic"))[0])
    nl, n = check_pocket_samples(calls[0], 8, 10, run_dir)
    s = calls[0]["s"]
    numbers["synthetic"] = {"n": n, "ligand_n": nl, "s": s, "s_per_step": s / (T + 1), "cli_s": sec,
                            "metrics": metrics}
    out["fwd"]["pocket_sample_cli"] = counts["message_layer"]
    print(f"pocket mol_gen_sample (8 synthetic pockets, T={T}): padded N={n} ({nl} ligand rows); "
          f"generate_ligands_in_pocket {s:.3f} s = {s / (T + 1):.6f} s per reverse step (card synchronized); "
          f"the CLI {sec:.3f} s with set-up; launches {counts['message_layer']}; ligands finite, one type a real "
          f"atom, pocket rows bit-exact, pockets.json written; metrics (printed, not judged) {metrics}")

    # (c) into the binding site of a PDB file: T=100, 2 resamplings, jumps of 10
    pdb = os.path.join(root, "site.pdb")
    coords, _ = write_pocket_pdb(pdb)
    site_x, site_aa = load_pocket_pdb(pdb, ligand_resname="LIG")
    if not np.array_equal(site_x, coords):
        raise AssertionError(f"the PDB pocket has {len(site_x)} CAs, not the 40 written")
    steps = 190 + 1
    with spy(torch, mol_gen_sample, "generate_ligands_in_pocket") as calls:
        metrics, sec, counts = run(lambda: mol_gen_sample.main(cli + [
            f"pocket_file={pdb}", "pocket_ligand=LIG", "num_timesteps=100", "num_resamplings=2",
            "jump_length=10", f"output_dir={root}/pdb"]))
    if len(calls) != 1 or counts["message_layer"] != layers * steps:
        raise AssertionError(f"PDB pocket sampling launched {counts}, need {layers * steps}")
    run_dir = os.path.join(root, "pdb", os.listdir(os.path.join(root, "pdb"))[0])
    nl, n = check_pocket_samples(calls[0], 8, 10, run_dir)
    if not np.array_equal(calls[0]["args"][2][0], site_x) or not np.array_equal(calls[0]["args"][3][0], site_aa):
        raise AssertionError("the PDB pocket sampled from is not the binding site")
    s = calls[0]["s"]
    numbers["pdb"] = {"n": n, "ligand_n": nl, "s": s, "s_per_step": s / steps, "cli_s": sec, "metrics": metrics}
    out["fwd"]["pocket_pdb_cli"] = counts["message_layer"]
    print(f"pocket mol_gen_sample (PDB binding site, 40 CAs; T=100, 2 resamplings, jumps of 10: 190 steps and "
          f"a decode): padded N={n}; {s:.3f} s = {s / steps:.6f} s per denoiser call; launches "
          f"{counts['message_layer']}; checks as above; metrics (printed, not judged) {metrics}")

    # (d) the QM9 inpainting mode: 8 molecules of 19 atoms, T=1000, seed weights
    with spy(torch, mol_gen_sample, "inpaint_first_node") as calls:
        metrics, sec, counts = run(lambda: mol_gen_sample.main([
            "device=cuda", "precision=fp32", "ddpm_mode=inpainting", "num_samples=8", "num_nodes=19",
            f"output_dir={root}/inpainting"]))
    qm9_layers = 9
    if len(calls) != 1 or counts["message_layer"] != qm9_layers * (T + 1):
        raise AssertionError(f"inpainting launched {counts}, need {qm9_layers * (T + 1)}")
    xh, mask = calls[0]["result"]
    x = xh[..., :3] - xh[:, :1, :3]  # centred on the fixed part, the first node
    if xh.shape != (8, 19, 3 + 5 + 1) or not np.isfinite(xh).all() or np.any(x[:, 0] != 0) \
            or not np.array_equal(xh[..., 3:8].sum(-1), mask):
        raise AssertionError("inpainting: non-finite values, a moved fixed node or not one type an atom")
    s = calls[0]["s"]
    numbers["inpainting"] = {"n": 19, "s": s, "s_per_step": s / (T + 1), "cli_s": sec, "metrics": metrics}
    out["fwd"]["inpainting_cli"] = counts["message_layer"]
    print(f"QM9 inpainting (8 molecules of 19, first node fixed at the origin, T={T}): {s:.3f} s = "
          f"{s / (T + 1):.6f} s per reverse step; launches {counts['message_layer']}; finite, the fixed node at "
          f"the origin after centring on it, one type an atom; metrics (printed, not judged) {metrics}")
    return out, numbers

def count_run(torch, fn):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after -> (result, seconds, counts)."""
    from bio_diffusion_torch.ops import message_layer as ml

    ml.reset_launch_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, dict(ml.launch_counts)


def check_frames(frames, mask, what):
    """Chain states ``[K, B, N, 3+F]`` on the data scale: finite, CoM-free
    positions, padded rows 0."""
    import numpy as np

    m = mask > 0
    x = frames[..., :3]
    com = (x * m[None, ..., None]).sum(-2) / m.sum(-1)[None, :, None]
    if not np.isfinite(frames).all() or np.abs(com).max() > 1e-3 * max(1.0, np.abs(x).max()) \
            or np.any(frames[:, ~m] != 0):
        raise AssertionError(f"{what}: non-finite states, positions off their CoM or nonzero padded rows")


def drive_chain_path(torch):
    """``cli.mol_gen_sample.main ddpm_mode=chain`` on ``qm9_mol_gen_ddpm`` at
    full width, fp32, seed weights: one molecule of 19 atoms, T=1000,
    ``keep_frames=100`` -> 100 kept states (every 10th step from the first)
    written with the last one repeated 10 times = 110 xyz files, 9 x 1,001
    launches; the kept states finite, CoM-free, padded rows 0 (none at
    N=19) -> (launches by path, numbers)."""
    from bio_diffusion_torch.cli import mol_gen_sample
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    root = os.path.join(REPO, "outputs", "chain_path")
    shutil.rmtree(root, ignore_errors=True)
    with spy(torch, SegmentedSampler, "run") as calls:
        metrics, sec, counts = count_run(torch, lambda: mol_gen_sample.main([
            "device=cuda", "precision=fp32", "ddpm_mode=chain", "num_nodes=19", "keep_frames=100",
            f"output_dir={root}"]))
    layers, T = 9, 1000
    if len(calls) != 1 or counts["message_layer"] != layers * (T + 1) or counts["message_layer_bwd"]:
        raise AssertionError(f"the chain mode launched {counts} in {len(calls)} run(s), need {layers * (T + 1)}")
    xh, frames = calls[0]["result"]
    mask = calls[0]["args"][1]
    if frames.shape != (100, 1, 19, 9) or xh.shape != (1, 19, 9):
        raise AssertionError(f"chain frames {frames.shape}, xh {xh.shape}")
    check_frames(frames, mask, "chain")
    chain_dir = os.path.join(root, os.listdir(root)[0], "chain")
    files = sorted(f for f in os.listdir(chain_dir) if f.startswith("chain_") and f.endswith(".xyz"))
    gif = os.path.exists(os.path.join(chain_dir, "output.gif"))
    if len(files) != 110:
        raise AssertionError(f"{len(files)} chain frame files, need 110")
    s = calls[0]["s"]
    print(f"chain path: mol_gen_sample ddpm_mode=chain, 1 molecule of 19 atoms, T={T}, fp32: {s:.3f} s = "
          f"{s / (T + 1):.6f} s per reverse step at B=1 (card synchronized); the CLI {sec:.3f} s with set-up; "
          f"launches {counts['message_layer']}; {len(files)} frame files (100 kept states + 10 repeats of the "
          f"last kept one, the state after step 990); frames finite, CoM-free, no padded row at N=19; GIF "
          f"written: {gif}; metrics (printed, not judged) {metrics}")
    return {"fwd": {"chain_cli": counts["message_layer"]}}, {"s_per_step": s / (T + 1), "cli_s": sec, "gif": gif}


def drive_sweep_path(torch, data_dir, ckpt_dir):
    """``cli.mol_gen_eval_conditional_qm9.main task=qualitative`` on the
    conditional model of ``ckpt_dir`` and the QM9-layout files of
    ``data_dir``: one sweep of 100 molecules of 19 atoms at T=1000 (9 x
    1,001 launches, 100 xyz files); then the sweep's sampler again at T=50
    on contexts ``[c0, c0, c1, c1]``: the molecules of equal context must be
    bit-identical and those of different context differ (they share one
    noise draw) -> (launches by path, numbers)."""
    import numpy as np

    from bio_diffusion_torch.cli import mol_gen_eval_conditional_qm9
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    root = os.path.join(REPO, "outputs", "sweep_path")
    shutil.rmtree(root, ignore_errors=True)
    with spy(torch, SegmentedSampler, "run") as calls:
        result, sec, counts = count_run(torch, lambda: mol_gen_eval_conditional_qm9.main([
            f"datamodule.dataloader_cfg.data_dir={data_dir}", f"generator_model_filepath={ckpt_dir}",
            "task=qualitative", "num_sweeps=1", "sweep_n_frames=100", "device=cuda", "precision=fp32",
            f"output_dir={root}"]))
    layers, T = 9, 1000
    if result != {"property": "alpha", "sweeps": 1} or len(calls) != 1 \
            or counts["message_layer"] != layers * (T + 1):
        raise AssertionError(f"the sweep returned {result}, launched {counts} in {len(calls)} run(s)")
    sweep_dir = os.path.join(root, "alpha", "sweep_0")
    files = [f for f in os.listdir(sweep_dir) if f.startswith("conditional_") and f.endswith(".xyz")]
    xh = calls[0]["result"]
    sampler, mask = calls[0]["args"][0], calls[0]["args"][1]
    context = calls[0]["kwargs"]["context"]
    if len(files) != 100 or xh.shape != (100, 19, 8) or not np.isfinite(xh).all() \
            or not calls[0]["kwargs"]["fix_noise"] or not np.all(np.diff(context[:, 0, 0]) > 0):
        raise AssertionError(f"the sweep wrote {len(files)} files; shape {xh.shape}, increasing contexts, "
                             "fixed noise expected")
    s = calls[0]["s"]
    equal = context[[0, 0, 99, 99]]
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs = sampler.run(mask[:4], gen, num_timesteps=50, fix_noise=True, context=equal)
    if not (np.array_equal(xs[0], xs[1]) and np.array_equal(xs[2], xs[3])) or np.array_equal(xs[1], xs[2]):
        raise AssertionError("molecules of one noise draw: equal contexts must give bit-identical molecules, "
                             "different ones different molecules")
    print(f"sweep path: mol_gen_eval_conditional_qm9 task=qualitative, 100 molecules of 19 atoms sharing one "
          f"noise draw, T={T}, fp32: {s:.3f} s = {s / (T + 1):.6f} s per reverse step at B=100 (card "
          f"synchronized); the CLI {sec:.3f} s with set-up; launches {counts['message_layer']}; 100 xyz files; "
          f"equal contexts (T=50, 4 molecules) bit-identical, different contexts different: ok")
    return {"fwd": {"sweep_cli": counts["message_layer"]}}, {"s_per_step": s / (T + 1), "cli_s": sec}


def drive_bench_serve(torch, name, env, layers, charges=True):
    """``cli.bench_serve.main`` in this process with the ``SERVE_*`` knobs
    of ``env``: the launch count must be ``layers`` per denoiser call of
    every executed batch (the warm-up's one step and decode a bucket, then
    each batch's T steps and decode); every request's molecules pass
    ``check_molecules`` -> (launches, result)."""
    from bio_diffusion_torch.cli import bench_serve
    from bio_diffusion_torch.serve import MoleculeServer

    steps = int(env["SERVE_STEPS"])
    with spy(torch, MoleculeServer, "generate") as requests, spy(torch, MoleculeServer, "warmup") as warm:
        result, sec, counts = count_run(torch, lambda: bench_serve.main([], env=env))
    buckets = warm[0]["result"]
    batches = result["stats"]["batches"]
    need = layers * (2 * len(buckets) + (steps + 1) * batches)
    for call in requests:
        check_molecules(call["result"]["molecules"], call["args"][1], charges=charges)
    print(f"bench_serve {name}: {json.dumps(result)}")
    print(f"bench_serve {name}: {sec:.3f} s in all; {len(buckets)} bucket(s) warmed (largest {max(buckets)}), "
          f"{batches} batches {result['stats']['bucket_batches']}; launches {counts['message_layer']} (need "
          f"{need}: {layers} a denoiser call); {len(requests)} requests' molecules checked")
    if counts["message_layer"] != need or counts["message_layer_bwd"] or len(requests) != int(env["SERVE_REQUESTS"]):
        raise AssertionError(f"bench_serve {name}: launches {counts}, need {need}")
    return counts["message_layer"], result


def drive_serving_benchmarks(torch):
    """``cli.bench_serve`` at full width in bf16: QM9 at a fixed size
    (batch 250, N=19, 100 steps, 4 requests, 2 clients), the QM9 size mix
    (batch 32, sizes drawn over the bucket ladder, 100 steps, 8 requests of
    32, 4 clients) and GEOM-Drugs (``SERVE_EXPERIMENT=geom_mol_gen_ddpm``,
    bf16, batch 8, sizes drawn, buckets up to 181, 50 steps, 4 requests of
    8: no charges) -> (launches by path, numbers)."""
    base = {"SERVE_PRECISION": "bf16"}
    runs = {
        "bench_serve_fixed": (dict(base, SERVE_NODES="19", SERVE_BATCH="250", SERVE_STEPS="100",
                                   SERVE_REQUESTS="4", SERVE_CONCURRENCY="2"), 9, True),
        "bench_serve_mix": (dict(base, SERVE_NODES="dist", SERVE_BATCH="32", SERVE_STEPS="100",
                                 SERVE_REQUESTS="8", SERVE_REQ_MOLS="32", SERVE_CONCURRENCY="4"), 9, True),
        "geom_serve": (dict(base, SERVE_EXPERIMENT="geom_mol_gen_ddpm", SERVE_NODES="dist", SERVE_BATCH="8",
                            SERVE_STEPS="50", SERVE_REQUESTS="4", SERVE_REQ_MOLS="8", SERVE_CONCURRENCY="4"),
                       4, False),
    }
    out, numbers = {"fwd": {}}, {}
    for name, (env, layers, charges) in runs.items():
        launches, result = drive_bench_serve(torch, name, env, layers, charges)
        stats = result["stats"]
        out["fwd"][name] = launches
        numbers[name] = {"molecules_per_s": result["value"], "denoiser_evals_per_s": result["denoiser_evals_per_s"],
                         "latency_s": result["latency_s"], "batches": stats["batches"],
                         "s_per_denoiser_call": stats["device_s"] / (stats["batches"] * (int(env["SERVE_STEPS"]) + 1))}
    return out, numbers


def corrupt_padding(batch):
    """A copy of ``batch`` with garbage in one padded row of x."""
    import dataclasses

    import numpy as np

    x = np.asarray(batch.x).copy()
    bi, ni = np.argwhere(np.asarray(batch.node_mask) == 0)[0]
    x[bi, ni] = 7.7
    return dataclasses.replace(batch, x=x)


def timed_steps(torch, trainer, steps):
    """ms per step of ``steps`` further Trainer steps (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    first = trainer.state.count
    start.record()
    trainer.train_epoch(epoch=first, max_steps=first + steps)
    end.record()
    torch.cuda.synchronize()
    if trainer.state.count != first + steps:
        raise AssertionError(f"{trainer.state.count - first} steps ran, not {steps}")
    return start.elapsed_time(end) / steps


def drive_debug_and_profile(torch):
    """``cli.train.main`` at QM9 full width on the synthetic data (fp32, B=64):
    2 steps with ``trainer.detect_anomaly=true`` (the invariants pass), one
    step on a batch with a corrupted padded row (must raise the masked-input
    check), then 2 steps with ``--profile`` and ``--dump-graph`` (checks
    off): the trace names the forward and backward row kernels,
    ``exec_time.log`` and ``graph/dynamics.ops.txt`` exist.  Each run's
    launch counts are held exactly; further steps of the debug trainer are
    timed with its checks switched on and off, in 8 turns of 6 steps (on,
    off, off, on, on, off, off, on) -> (launches by path, numbers)."""
    from bio_diffusion_torch.cli.train import main
    from bio_diffusion_torch.utils.debug import InvariantError

    root = os.path.join(REPO, "outputs", "debug_profile")
    shutil.rmtree(root, ignore_errors=True)
    args = ["experiment=qm9_mol_gen_ddpm", "datamodule.dataloader_cfg.dataset=synthetic", "trainer.precision=fp32",
            "trainer.check_val_every_n_epoch=1", "--device=cuda", "--max-steps=2"]
    out, numbers = {"fwd": {}, "bwd": {}}, {}
    runs = {"debug_train": ["trainer.detect_anomaly=true", f"--workdir={root}/debug"],
            "profile_train": [f"--profile={root}/trace", "--dump-graph", f"--workdir={root}/profile"]}
    trainers = {}
    for name, extra in runs.items():
        trainer, sec, counts = count_run(torch, lambda: main(args + extra))
        layers, st = trainer.exp.model_cfg.num_encoder_layers, trainer.stats
        need = {"message_layer": layers * (st["micro_batches"] + 2 * st["eval_batches"]),
                "message_layer_bwd": layers * st["micro_batches"]}
        # the graph dump's one denoiser call at B=2
        need["message_layer"] += layers if name == "profile_train" else 0
        print(f"{name}: cli.train.main {st['steps']} steps (B=64, N=29), {st['eval_batches']} EMA validation "
              f"batches, {sec:.3f} s with set-up; launches {counts} (need {need})")
        if st["steps"] != 2 or {k: counts[k] for k in need} != need:
            raise AssertionError(f"{name}: the launch counts are not exact")
        out["fwd"][name], out["bwd"][name] = counts["message_layer"], counts["message_layer_bwd"]
        trainers[name] = trainer
    dbg = trainers["debug_train"]
    if not dbg.exp.diffusion_cfg.debug_invariants or trainers["profile_train"].exp.diffusion_cfg.debug_invariants:
        raise AssertionError("trainer.detect_anomaly did not switch the invariants on (or they are on by default)")
    # one trainer's steps with its checks on and off in turns; its step reads
    # the switch at every call
    dc, turns = dbg.evd.diffusion_cfg, {"on": [], "off": []}
    for label in ("on", "off", "off", "on") * 2:
        dc.debug_invariants = label == "on"
        turns[label].append(timed_steps(torch, dbg, 6))
    dc.debug_invariants = True
    for label, ms in turns.items():
        numbers[f"ms_per_step_checks_{label}"] = statistics.median(ms)
    numbers["turns_ms"] = turns
    bad = corrupt_padding(next(dbg._batch_iter("train"))).to(dbg.device)
    try:
        dbg.train_step(dbg.state, bad, dbg.generator)
    except InvariantError as e:
        if not str(e).startswith("input x is not correctly masked (max |pad| = 7.69999"):
            raise
        print(f"debug_train: a corrupted padded row raised InvariantError: {e}")
    else:
        raise AssertionError("a corrupted padded row did not raise the masked-input check")
    with open(os.path.join(root, "trace", "trace.json")) as f:
        trace = f.read()
    exec_log = os.path.join(root, "profile", "exec_time.log")
    ops = os.path.join(root, "profile", "graph", "dynamics.ops.txt")
    if "message_layer_kernel" not in trace or "bwd_rows_kernel" not in trace or not os.path.exists(exec_log) \
            or not os.path.exists(ops) or not os.path.exists(os.path.join(root, "debug", "exec_time.log")):
        raise AssertionError("the profile run's trace, exec_time.log or graph dump is missing or incomplete")
    numbers["trace_mb"] = len(trace) / 2**20
    with open(exec_log) as f:
        numbers["profile_exec_time"] = f.read().strip()
    print(f"debug and profile: {numbers['ms_per_step_checks_on']:.3f} ms/step with the checks on, "
          f"{numbers['ms_per_step_checks_off']:.3f} ms/step off (CUDA events, the median of 4 turns of 6 "
          f"further steps of one trainer each: {turns}); the trace "
          f"({numbers['trace_mb']:.1f} MiB) names message_layer_kernel and bwd_rows_kernel; exec_time.log "
          f"{numbers['profile_exec_time']}; graph/dynamics.ops.txt written")
    return out, numbers


def check_molecules(mols, num_samples, charges=True):
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
        if charges and len(mol["charges"]) != mol["size"]:
            raise AssertionError("charges missing")
        if not charges and "charges" in mol:
            raise AssertionError("charges from a model without a charge channel")


def drive_main_path(torch, b1_ms_b250):
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
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
        step_ms = time_reverse_steps(torch, server, layers, b1_ms_b250)
        return launches, step_ms
    finally:
        server.close()


def time_reverse_steps(torch, server, layers, b1_ms, b=250, n=19, steps=20):
    """Ancestral reverse steps of the server's model (bf16) at the reference
    workload's shape, B=250 molecules of N=19 atoms, through
    ``EquivariantVariationalDiffusion.reverse_segment`` (the sampler's loop):
    CUDA events over ``steps`` steps after 2 warm-up steps; the step's share
    taken by the message-layer kernel's ``layers`` launches, at ``b1_ms``
    each (timed alone at this shape) -> ms per step."""
    import numpy as np

    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.train.sampling import make_node_mask

    evd = server.sampler.evd
    mask = torch.as_tensor(make_node_mask([n] * b, n), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    T = int(evd.T)
    s_values = np.arange(T - 1, T - 3 - steps, -1, dtype=np.float32)
    with torch.inference_mode():
        z = evd.init_sample_noise(mask, gen)
        z, _ = evd.reverse_segment(z, s_values[:2] / T, (s_values[:2] + 1) / T, mask, gen)
        launches0 = ml.launch_counts["message_layer"]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        z, _ = evd.reverse_segment(z, s_values[2:] / T, (s_values[2:] + 1) / T, mask, gen)
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    launches = ml.launch_counts["message_layer"] - launches0
    if z.shape != (b, n, evd.num_x_dims + evd.num_node_scalar_features) or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"reverse steps at B={b} gave shape {tuple(z.shape)} or non-finite values")
    if launches != layers * steps:
        raise AssertionError(f"{launches} kernel launches in {steps} reverse steps, need {layers * steps}")
    print(f"reverse step bf16 B={b} N={n}: {ms:.4f} ms/step over {steps} steps (CUDA events), "
          f"{b * 1e3 / ms:.1f} denoiser evals/s; the message-layer kernel's "
          f"{layers} launches ({layers} x {b1_ms:.4f} ms, timed alone) = {100 * layers * b1_ms / ms:.1f}% "
          f"of the step")
    return ms


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


def chain_inputs(torch, evd, e, dtype, seed):
    """Flat edge rows s [E, S], v [E, 3V], frames_t [E, 9] drawn from ``seed``
    and the chain weights of layer 0 of the full-width model, on the card."""
    from bio_diffusion_torch.models.gcpnet import stack_chain_weights

    mc = evd.dynamics_network.model_cfg
    mp = evd.dynamics_network.interaction_layers[0].interaction
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = [torch.randn(e, mc.h_hidden_dim, generator=gen, device="cuda"),
            torch.randn(e, 3 * mc.chi_hidden_dim, generator=gen, device="cuda"),
            torch.rand(e, 9, generator=gen, device="cuda") * 2 - 1]
    with torch.no_grad():
        weights = [w.contiguous() for w in stack_chain_weights(mp, dtype)]
    return [r.to(dtype) for r in rows] + weights


def check_chain(torch, evd):
    """The flat-edge chain kernel against its plain version, then both timed."""
    from bio_diffusion_torch.ops.gcp2_chain import fused_gcp2_chain, gcp2_chain_plain
    from bio_diffusion_torch.ops.message_layer import chain_stage_macs

    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for e in (53824, 90250, 4001):
            args = chain_inputs(torch, evd, e, dtype, seed=e)
            out = fused_gcp2_chain(*args)
            plain = gcp2_chain_plain(*args)
            torch.cuda.synchronize()
            worst_abs, worst_rel = 0.0, 0.0
            for part, k, p in zip(("s", "v"), out, plain):
                err = (k.float() - p.float()).abs().max().item()
                ref = p.float().abs().max().item()
                ok = k.dtype == dtype and bool(torch.isfinite(k).all()) and err <= TOL_REL[name] * ref
                print(f"chain-kernel-vs-plain {name} E={e} {part}: max_abs_err={err:.6g} max|plain|={ref:.6g} "
                      f"rel={err / ref:.3g} tol={TOL_REL[name]:g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"GCP2 chain kernel disagrees with the plain version ({name}, E={e})")
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / ref)
            if e == 4001:
                continue
            kernel_ms, plain_ms, runs = in_turns(torch, lambda: fused_gcp2_chain(*args),
                                                 lambda: gcp2_chain_plain(*args), reps=10)
            s_dim, v3, g = args[0].shape[1], args[1].shape[1], args[3].shape[0]
            flops = 2.0 * e * (g * chain_stage_macs(s_dim, v3 // 3, args[3].shape[2]) + s_dim)
            bound_ms, bound_by = bound(flops, nbytes(args, out), name)
            print(f"timing chain {name} E={e}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}) (runs {runs})")
            result[(name, e)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                     max_abs_err=worst_abs, max_rel_err=worst_rel)
    return result


def unfused_inputs(torch, args, ve):
    """The fused layer's (s_node, v_node, epack) as the unfused path's
    (s_node, v_node_cm, e, xi_cm, frames_flat, edge_mask)."""
    s_node, v_node, epack = args[:3]
    b, n, _ = s_node.shape
    se = epack.shape[-1] - 3 * ve - 10
    ep = epack.reshape(b, n, n, -1)
    return (s_node, v_node.reshape(b, n, 3, -1), ep[..., :se], ep[..., se:se + 3 * ve].reshape(b, n, n, 3, ve),
            ep[..., se + 3 * ve:se + 3 * ve + 9].reshape(b * n * n, 9), ep[..., -1])


def drive_unfused(torch, evd):
    """The unfused message-passing path (first GCP by torch.matmul, the chain
    kernel, masked sum) against the fused kernel on the same layer inputs and
    weights at B=64, N=29; both timed.  Returns the chain kernel's launches in
    this phase and the timings."""
    from bio_diffusion_torch.models.gcpnet import message_passing_unfused
    from bio_diffusion_torch.ops import message_layer as ml

    mp = evd.dynamics_network.interaction_layers[0].interaction
    result = {}
    ml.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        args, ve = kernel_inputs(torch, evd, 64, 29, dtype, True, seed=640)
        ins = unfused_inputs(torch, args, ve)

        def unfused():
            with torch.no_grad():
                return message_passing_unfused(mp, *ins, use_kernel=True)

        s_u, v_u = unfused()
        s_f, v_f = ml.fused_message_layer(*args, ve_dim=ve)
        torch.cuda.synchronize()
        for part, u, f in (("s_agg", s_u, s_f), ("v_agg", v_u.reshape(v_f.shape), v_f)):
            err = (u.float() - f.float()).abs().max().item()
            ref = f.float().abs().max().item()
            ok = u.dtype == dtype and bool(torch.isfinite(u).all()) and err <= TOL_UNFUSED_REL[name] * ref
            print(f"unfused-vs-fused {name} B=64 N=29 {part}: max_abs_err={err:.6g} max|fused|={ref:.6g} "
                  f"rel={err / ref:.3g} tol={TOL_UNFUSED_REL[name]:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the unfused path disagrees with the fused kernel ({name})")
        unfused_ms, fused_ms, runs = in_turns(torch, unfused, lambda: ml.fused_message_layer(*args, ve_dim=ve),
                                              reps=5)
        print(f"timing layer {name} B=64 N=29: unfused path (chain kernel) {unfused_ms:.4f} ms, "
              f"fused kernel {fused_ms:.4f} ms (runs {runs})")
        result[name] = dict(unfused_ms=unfused_ms, fused_ms=fused_ms)
    launches = ml.launch_counts["gcp2_chain"]
    print(f"unfused path: {launches} chain kernel launches")
    if launches < 1:
        raise AssertionError("the unfused path did not launch the chain kernel")
    return launches, result


def check_passes(torch):
    """Each op of the pass probe, kernel against plain version at k=8 over the
    default shape; then the probe itself, whose launches are counted."""
    from bio_diffusion_torch.cli import bench_passes
    from bio_diffusion_torch.ops import message_layer as ml
    from bio_diffusion_torch.ops.passes import OPS, repeat_op, repeat_op_plain

    x = torch.randn(90250, 256, generator=torch.Generator(device="cuda").manual_seed(8), device="cuda")
    worst = 0.0
    for op in OPS:
        out, plain = repeat_op(x, op, 8), repeat_op_plain(x, op, 8)
        torch.cuda.synchronize()
        finite = torch.isfinite(plain)
        err = (out - plain)[finite].abs().max().item() if bool(finite.any()) else 0.0
        scale = max(1.0, plain[finite].abs().max().item() if bool(finite.any()) else 0.0)
        ok = torch.equal(torch.isfinite(out), finite) and err <= TOL_PASSES_REL * scale
        print(f"passes-kernel-vs-plain {op} k=8: max_abs_err={err:.6g} scale={scale:.6g} "
              f"{int(finite.sum())} finite, tol={TOL_PASSES_REL:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"pass-probe kernel disagrees with the plain version ({op})")
        worst = max(worst, err)
    ml.reset_launch_counts()
    probe = bench_passes.main([])  # holds the built library's SASS counts against PASS_SASS
    launches = ml.launch_counts["elementwise_passes"]
    if launches < 1:
        raise AssertionError("the probe did not launch its kernel")
    print(f"passes: SASS counts {'read and held against PASS_SASS' if probe['sass_checked'] else 'not read (no cuobjdump)'}")
    return worst, launches, probe


def passes_row(torch, probe) -> dict:
    """The pass probe's kernels-line fields: ``mul`` at k=104 (its bound from
    its SASS counts) and at k=1 beside one ``torch.mul`` call, and per op
    the slopes, the bound of a pass and the price the accounting takes, the
    share of the k=104 bound and the SASS counts (read in this run where
    ``sass_checked``, else the committed table)."""
    from bio_diffusion_torch.cli import bench_passes
    from bio_diffusion_torch.ops.passes import kernel_grid

    mul = probe["per_pass"]["mul"]
    parts = bench_passes.pass_bounds("mul", probe["rows"] * probe["cols"], bench_passes.K_HI)
    by = max(parts, key=parts.get)
    ops = {op: {"ns_per_pass": {"kernel": 1e6 * r["kernel_pass_ms"], "plain": 1e6 * r["plain_pass_ms"]},
                "bound_ns_per_pass": r["bound_ns_per_pass"], "bound_by": r["bound_by"],
                "price_ns_per_pass": r["price_ns_per_pass"], "ms_k208": r["kernel_k208_ms"],
                "share_of_bound": r["share_of_bound"], "ms_k104": r["kernel_k104_ms"],
                "bound_ms_k104": r["bound_k104_ms"], "ms_k8": r["kernel_k8_ms"], "ms_k1": r["kernel_k1_ms"],
                "library_ms_k1": r["library_k1_ms"], "sass": r["sass"],
                "blocks_per_sm": kernel_grid(torch.device("cuda"), op)[0]}
           for op, r in probe["per_pass"].items()}
    return {"ms": mul["kernel_k104_ms"], "plain_ms": mul["plain_k104_ms"], "bound_ms": max(parts.values()),
            "bound_by": "bytes" if by == "bytes" else "operations", "ms_k1": mul["kernel_k1_ms"],
            "library_ms": mul["library_k1_ms"], "ops": ops, "clocks_sm_mhz": probe["clocks_sm_mhz"],
            "sass_checked": probe["sass_checked"], "priced_at_bound": probe["priced_at_bound"]}


# the data-parallel phase: the train steps two ranks take on one card, and
# the multi-device sampler's batch (65 molecules of 19 atoms: ragged across
# two devices) and steps
DP_STEPS = 3
DP_SAMPLE_B, DP_SAMPLE_N, DP_SAMPLE_T = 65, 19, 50
# the two-rank steps against one process on the whole batch: loss and grad
# norm relative (float32, the mean of two half-batch means against one
# mean); the parameters within 2 lr a step (AMSGrad moves an element whose
# gradient is near 0 by about +lr in one run and -lr in the other,
# tests/test_torch_train_step.py:163-175), their median far below
TOL_DP_REL = 1e-4
# the multi-device sampler against one device, bf16, relative to max|x| of
# the single-device positions: the replicas' PyTorch products run over other
# row counts (cuBLAS may pick another algorithm), rounding at bf16's ulp.
# Every run of the split read 1.3e-3 (PERF.md section 5); the limit lies
# between that and the planted fault's reading (one molecule's rows of the
# draws swapped with another's on the other replica), which the phase
# measures too and must find above it
TOL_DP_SAMPLE_REL = 1e-2
DP_TIMEOUT_S = 300


def dp_experiment(data_dir):
    """The user path's training configuration: full QM9 width, float32,
    batch 64 of the QM9-layout files."""
    from bio_diffusion_torch.config.build import build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config

    return build_experiment(load_config(default_config_dir(), "train", [
        "experiment=qm9_mol_gen_ddpm", "datamodule.dataloader_cfg.dataset=QM9",
        f"datamodule.dataloader_cfg.data_dir={data_dir}", "datamodule.dataloader_cfg.batch_size=64",
        "trainer.precision=fp32"]))


def dp_steps(torch, trainer, steps):
    """``init_state`` and the Trainer's first ``steps`` train batches
    through its train step, the launch counts set to 0 just before the steps
    and read just after -> (per-step loss and grad norm, counts, seconds,
    the ``[B, N]`` of each denoiser call)."""
    from bio_diffusion_torch.ops import message_layer as ml

    trainer.init_state(resume=False)
    batches = [b.to(trainer.device) for _, b in zip(range(steps), trainer._train_batches())]
    seen = []  # the [B, N] the denoiser is given: this rank's rows
    hook = trainer.evd.dynamics_network.register_forward_pre_hook(lambda _, args: seen.append(tuple(args[0].shape[:2])))
    torch.cuda.synchronize()
    ml.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [trainer.train_step(trainer.state, b, trainer.generator) for b in batches]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    hook.remove()
    return ([{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])} for m in metrics],
            dict(ml.launch_counts), sec, seen)


def dp_train_rank(rank, world, init_file, data_dir, out_dir):
    """One rank of phase (a), in a process of its own: gloo over CUDA
    tensors (two ranks on one card; NCCL refuses that), the Trainer's steps
    on its rows of each global batch, the all-reduce timed around each call
    (the card synchronized before and after); writes its metrics, counts,
    the sum of its own initial weights and its final parameters."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bio_diffusion_torch.parallel import distributed
    from bio_diffusion_torch.train import loop
    from bio_diffusion_torch.utils.logging import MetricLoggers

    dp = distributed.init_distributed(device=torch.device("cuda", 0), backend="gloo",
                                      init_method=f"file://{init_file}", rank=rank, world=world,
                                      timeout_s=DP_TIMEOUT_S)
    reduce_ms, reduce = [], distributed.all_reduce_mean_

    def timed(tensors, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(tensors, group)
        torch.cuda.synchronize()
        reduce_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    distributed.all_reduce_mean_ = timed
    # rank 1 draws its initial weights from another seed (its batches and
    # draws keep the run's seed): init_state's broadcast must replace them
    own_init, init_sums = loop.init_random_weights, []

    def init(evd, seed):
        own_init(evd, seed + rank)
        init_sums.append(float(sum(p.double().sum() for p in evd.parameters())))

    loop.init_random_weights = init
    trainer = loop.Trainer(dp_experiment(data_dir), os.path.join(out_dir, f"rank{rank}"), dp.device,
                           loggers=MetricLoggers(), dp=dp)
    metrics, counts, sec, shapes = dp_steps(torch, trainer, DP_STEPS)
    result = {"rank": dp.rank, "world": dp.world, "backend": dp.backend, "metrics": metrics, "counts": counts,
              "s": sec, "reduce_ms": reduce_ms, "shapes": shapes, "init_sum": init_sums[0],
              "params": [p.detach().cpu() for p in trainer.state.params]}
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


def run_ranks(target, world, args):
    """``target(rank, world, *args)`` in ``world`` spawned processes (CUDA
    state does not survive a fork), each joined within ``DP_TIMEOUT_S`` and
    killed past it; a rank that fails or times out raises."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, *args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + DP_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if late or bad:
        raise AssertionError(f"data-parallel ranks failed: timed out {late}, exit codes {bad}")


def dp_cli_rank(out_dir, args):
    """A rank of phase (b), started by ``torch.distributed.run``:
    ``cli.train.main(args)`` with the launch counts set to 0 just before it
    and read just after, written to ``out_dir/rank<r>.json``."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bio_diffusion_torch.cli import train
    from bio_diffusion_torch.ops import message_layer as ml

    ml.reset_launch_counts()
    trainer = train.main(args)
    torch.cuda.synchronize()
    st, dp = trainer.stats, trainer.dp
    with open(os.path.join(out_dir, f"rank{dp.rank}.json"), "w") as f:
        json.dump({"rank": dp.rank, "world": dp.world, "backend": dp.backend, "device": str(dp.device),
                   "model": dp.model,
                   "counts": dict(ml.launch_counts), "count": trainer.state.count, "micro_batches": st["micro_batches"],
                   "eval_batches": st["eval_batches"], "layers": trainer.exp.model_cfg.num_encoder_layers}, f)
    return 0


def drive_dp_cli(torch, data_dir, root, nproc, model=1):
    """Phase (b): ``cli.train`` under ``torch.distributed.run --standalone``
    with ``nproc`` ranks (NCCL, one a card) as ``nproc / model`` data x
    ``model`` model shards, 2 steps and one EMA validation batch -> launch
    counts by rank."""
    out_dir, workdir = os.path.join(root, f"cli_{nproc}"), os.path.join(root, f"cli_{nproc}", "train")
    os.makedirs(out_dir, exist_ok=True)
    args = ["experiment=qm9_mol_gen_ddpm", "datamodule.dataloader_cfg.dataset=QM9",
            f"datamodule.dataloader_cfg.data_dir={data_dir}", "datamodule.dataloader_cfg.batch_size=64",
            "trainer.precision=fp32", "trainer.check_val_every_n_epoch=1", "trainer.limit_train_batches=2",
            "trainer.limit_val_batches=1", "model.diffusion_cfg.sample_during_training=false", "--device=cuda",
            f"--workdir={workdir}", "--max-steps=2", "--max-epochs=1", f"trainer.num_model_shards={model}"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           f"--nproc_per_node={nproc}", os.path.abspath(__file__), "--dp-cli", out_dir, *args],
                          cwd=REPO, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torch.distributed.run of cli.train (nproc {nproc}) exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    ranks = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    ckpts = sorted(os.listdir(os.path.join(workdir, "checkpoints")))
    for rk in ranks:
        need_fwd = rk["layers"] * (rk["micro_batches"] + 2 * rk["eval_batches"])
        need_bwd = rk["layers"] * rk["micro_batches"]
        print(f"data parallel (b) cli.train nproc={nproc} rank {rk['rank']} of {rk['world']} on {rk['device']} "
              f"({rk['backend']}, {rk['model']} model shards): {rk['count']} steps, launches fwd "
              f"{rk['counts']['message_layer']} (need {need_fwd}), bwd {rk['counts']['message_layer_bwd']} (need "
              f"{need_bwd})")
        if rk["backend"] != "nccl" or rk["world"] != nproc or rk["count"] != 2 or rk["model"] != model \
                or rk["counts"]["message_layer"] != need_fwd or rk["counts"]["message_layer_bwd"] != need_bwd:
            raise AssertionError(f"cli.train under torch.distributed.run (nproc {nproc}) is not as planned: {rk}")
    if ckpts != ["step_2.pt"]:
        raise AssertionError(f"cli.train under torch.distributed.run wrote {ckpts}, need one checkpoint step_2.pt")
    print(f"data parallel (b): nproc={nproc} wrote {ckpts} in {sec:.3f} s (process start-up included)")
    return ranks, sec


def drive_data_parallel(torch, data_dir):
    """The data-parallel phase: (a) two ranks, two processes on one card,
    the Trainer's 3 steps at full QM9 width (fp32, global B=64, N=29) held
    against one process on the whole batches; (b) ``cli.train`` under
    ``torch.distributed.run`` at world 1 over NCCL (and world 2 on two
    cards); (c) the multi-device sampler against one device -> (launches by
    path of the forward and backward kernels, numbers, the one-process run
    of (a): its metrics, final parameters, learning rate and layers)."""
    import numpy as np

    from bio_diffusion_torch.cli.common import load_model
    from bio_diffusion_torch.train.loop import Trainer
    from bio_diffusion_torch.train.sampling import SegmentedSampler, make_node_mask
    from bio_diffusion_torch.utils.logging import MetricLoggers

    root = os.path.join(REPO, "outputs", "dp_path")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out, numbers = {"fwd": {}, "bwd": {}}, {}

    # (a) one process on the whole batches first, then the two ranks
    reference = Trainer(dp_experiment(data_dir), os.path.join(root, "reference"), "cuda", loggers=MetricLoggers())
    ref_metrics, ref_counts, ref_s, ref_shapes = dp_steps(torch, reference, DP_STEPS)
    ref_params = [p.detach().cpu() for p in reference.state.params]
    layers, lr = reference.exp.model_cfg.num_encoder_layers, reference.exp.optimizer.lr
    one_process = {"metrics": ref_metrics, "params": ref_params, "lr": lr, "layers": layers, "s": ref_s}
    del reference
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_ranks(dp_train_rank, 2, (os.path.join(root, "store"), data_dir, root))
    numbers["ranks_s"] = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    need = layers * DP_STEPS
    for rk in ranks:
        c = rk["counts"]
        print(f"data parallel (a) rank {rk['rank']} of {rk['world']} ({rk['backend']} over CUDA tensors): "
              f"denoiser rows {rk['shapes']} (one process: {ref_shapes}), "
              f"launches fwd {c['message_layer']} bwd {c['message_layer_bwd']} (need {need} and {need}), "
              f"{DP_STEPS} steps in {rk['s']:.3f} s, all-reduce ms {[round(t, 3) for t in rk['reduce_ms']]}")
        if c["message_layer"] != need or c["message_layer_bwd"] != need or rk["shapes"] != [(32, 29)] * DP_STEPS:
            raise AssertionError(f"rank {rk['rank']}: launches {c} or rows {rk['shapes']} are not as planned")
        out["fwd"][f"dp_train_rank{rk['rank']}"] = c["message_layer"]
        out["bwd"][f"dp_train_rank{rk['rank']}"] = c["message_layer_bwd"]
    if ref_counts["message_layer"] != need or ref_counts["message_layer_bwd"] != need \
            or ref_shapes != [(64, 29)] * DP_STEPS:
        raise AssertionError(f"the one-process reference launched {ref_counts}, need {need} and {need}")
    if ranks[0]["metrics"] != ranks[1]["metrics"]:
        raise AssertionError("the two ranks' reduced metrics differ")
    same = all(torch.equal(p, q) for p, q in zip(ranks[0]["params"], ranks[1]["params"]))
    print(f"data parallel (a): initial weights' sums {ranks[0]['init_sum']!r} (rank 0) and {ranks[1]['init_sum']!r} "
          f"(rank 1, another seed) before the broadcast; final parameters bit-equal across the ranks: {same}")
    if ranks[0]["init_sum"] == ranks[1]["init_sum"] or not same:
        raise AssertionError("rank 1 did not start from other weights, or its final parameters are not rank 0's")
    worst = 0.0
    for s, (a, b) in enumerate(zip(ranks[0]["metrics"], ref_metrics)):
        for k in ("loss", "grad_norm"):
            rel = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            worst = max(worst, rel)
            if rel > TOL_DP_REL:
                raise AssertionError(f"step {s} {k}: two ranks {a[k]} vs one process {b[k]} (rel {rel:.3g})")
    diffs = torch.cat([(p - q).abs().flatten() for p, q in zip(ranks[0]["params"], ref_params)])
    param_tol = 2 * lr * DP_STEPS
    max_diff, median_diff = float(diffs.max()), float(diffs.median())
    print(f"data parallel (a): per-step loss and grad norm of the two ranks {ranks[0]['metrics']} vs one process "
          f"{ref_metrics} (worst rel {worst:.3g}, tol {TOL_DP_REL}); parameters max |diff| {max_diff:.3g} "
          f"(tol 2 lr steps = {param_tol:.3g}), median {median_diff:.3g}")
    if max_diff > param_tol or median_diff > 1e-3 * lr:
        raise AssertionError("the two ranks' parameters are not the one process's")
    reduce_ms = [t for rk in ranks for t in rk["reduce_ms"][1:]]
    numbers.update(dp_train_steps=DP_STEPS, dp_train_ref_s=ref_s, dp_train_rank_s=[rk["s"] for rk in ranks],
                   allreduce_ms_first=[rk["reduce_ms"][0] for rk in ranks],
                   allreduce_ms_per_step=statistics.mean(reduce_ms),
                   max_rel_err=worst, param_max_abs_diff=max_diff, param_median_abs_diff=median_diff,
                   gradient_floats=int(sum(p.numel() for p in ref_params)))
    print(f"data parallel (a): all-reduce of {numbers['gradient_floats']:,} gradient floats + the step's metrics "
          f"{numbers['allreduce_ms_per_step']:.3f} ms a step (mean of steps 2-{DP_STEPS} of both ranks; the first "
          f"{[round(t, 3) for t in numbers['allreduce_ms_first']]} ms; two ranks on one card, gloo: no scaling "
          f"figure)")

    # (b) cli.train under torch.distributed.run: world 1 over NCCL, and world 2 on two cards
    cli_ranks, numbers["dp_cli_s"] = drive_dp_cli(torch, data_dir, root, 1)
    if torch.cuda.device_count() >= 2:
        more, numbers["dp_cli_2_s"] = drive_dp_cli(torch, data_dir, root, 2)
        cli_ranks += more
    else:
        print("data parallel (b): one card, so no nproc=2 run over NCCL")
    out["fwd"]["dp_cli"] = sum(rk["counts"]["message_layer"] for rk in cli_ranks)
    out["bwd"]["dp_cli"] = sum(rk["counts"]["message_layer_bwd"] for rk in cli_ranks)

    # (c) the multi-device sampler against one device, bf16, B=65 (ragged across two)
    from bio_diffusion_torch.ops import message_layer as ml

    evd = load_model(qm9_experiment("bf16"), None, torch.device("cuda"), seed=0)
    mask = make_node_mask(np.full(DP_SAMPLE_B, DP_SAMPLE_N), DP_SAMPLE_N)

    def sample(sampler, noises=None):
        return sampler.run(mask, torch.Generator(device="cuda").manual_seed(4), num_timesteps=DP_SAMPLE_T,
                           noises=noises)

    def planted_fault(sampler):
        """The run with the draws of the first molecule (first replica)
        and the last (second replica) swapped: a replica handed another's
        rows -> its positions' max |diff| from the one-device run."""
        g = torch.Generator(device="cuda").manual_seed(4)
        shape = (DP_SAMPLE_B, DP_SAMPLE_N, evd.num_x_dims + evd.num_node_scalar_features)
        noises = [torch.randn(shape, generator=g, device="cuda") for _ in range(DP_SAMPLE_T + 2)]
        for e in noises:
            e[[0, -1]] = e[[-1, 0]]
        return float(np.abs(sample(sampler, noises)[..., :3] - single[..., :3]).max())

    single, single_s, _ = count_run(torch, lambda: sample(SegmentedSampler(evd, devices=[torch.device("cuda", 0)])))
    numbers["sample_cuda:0_s"] = single_s
    sets = [[torch.device("cuda", 0)] * 2]
    if torch.cuda.device_count() >= 2:
        sets.append([torch.device("cuda", 0), torch.device("cuda", 1)])
    out["fwd"]["dp_sample"] = 0
    k = evd.num_atom_types
    for devices in sets:
        sampler = SegmentedSampler(evd, devices=devices)
        xh, sec, counts = count_run(torch, lambda: sample(sampler))
        need = layers * len(devices) * (DP_SAMPLE_T + 1)
        scale = float(np.abs(single[..., :3]).max())
        err = float(np.abs(xh[..., :3] - single[..., :3]).max())
        same_types = float((xh[..., 3:3 + k].argmax(-1) == single[..., 3:3 + k].argmax(-1)).mean())
        names = ", ".join(str(d) for d in devices)
        fault = planted_fault(sampler)
        entry = {"s": sec, "max_abs_err": err, "max_abs_x": scale, "same_types": same_types, "planted_fault": fault}
        again = ""
        if len(set(devices)) > 1:  # the first run paid the second card's first use: time a second
            entry["warm_s"] = count_run(torch, lambda: sample(sampler))[1]
            again = f" (again: {entry['warm_s']:.3f} s)"
        print(f"data parallel (c) SegmentedSampler(devices=[{names}]): B={DP_SAMPLE_B}, N={DP_SAMPLE_N}, bf16, "
              f"T={DP_SAMPLE_T}, {sec:.3f} s{again}; "
              f"launches {counts['message_layer']} (need {need}: {layers} a replica a step); positions max |diff| "
              f"{err!r} vs one device (max |x| {scale!r}, rel {err / scale:.3g}, tol {TOL_DP_SAMPLE_REL} relative; "
              f"the planted fault {fault!r}, rel {fault / scale:.3g}), atom types equal for "
              f"{100 * same_types:.2f}% of the atoms; one device {single_s:.3f} s")
        if xh.shape != single.shape or not np.isfinite(xh).all() or counts["message_layer"] != need \
                or err > TOL_DP_SAMPLE_REL * scale or same_types != 1.0:
            raise AssertionError(f"the multi-device sampler over [{names}] is not the one-device sampler")
        if fault <= TOL_DP_SAMPLE_REL * scale:
            raise AssertionError(f"the planted fault over [{names}] reads {fault!r}, within the limit: the check "
                                 "cannot see it")
        out["fwd"]["dp_sample"] += counts["message_layer"]
        numbers[f"sample_{names}"] = entry
    return out, numbers, one_process


# the model-axis phase: four ranks on one card as 2 data groups x 2 model
# shards, the data-parallel phase's configuration and steps (its one-process
# run is the reference, held at TOL_DP_REL and 2 lr a step as there), and
# MA_STEADY steps more after them, timed without the collective timers
MA_WORLD, MA_SHARDS, MA_STEADY = 4, 2, 3


def ma_rest_memory(torch, device):
    """``memory_allocated`` after the steps, and a second reading after one
    more allocation: blocks freed but waiting on another stream's events
    (the collectives') leave the count there, blocks still held do not."""
    torch.cuda.synchronize()
    at_rest = torch.cuda.memory_allocated()
    settle = torch.empty(1, device=device)
    return {"at_rest": at_rest, "at_rest_settled": torch.cuda.memory_allocated() - settle.untyped_storage().nbytes()}


def ma_steady_ms(torch, trainer, steps):
    """The ms of each of ``steps`` more train steps (on the first train
    batches again), after the measured ones, which were their warm-up; the
    card synchronized at each step's end."""
    batches = [b.to(trainer.device) for _, b in zip(range(steps), trainer._train_batches())]
    out = []
    torch.cuda.synchronize()
    for b in batches:
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, b, trainer.generator)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def ma_world1(rank, world, data_dir, out_dir):
    """World 1 of the model-axis phase in a process of its own, on a rank's
    basis: the same ``DP_STEPS`` steps, ``memory_allocated`` at rest after
    them, then ``MA_STEADY`` steps timed.  Writes its metrics and readings."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bio_diffusion_torch.train import loop
    from bio_diffusion_torch.utils.logging import MetricLoggers

    device = torch.device("cuda", 0)
    trainer = loop.Trainer(dp_experiment(data_dir), os.path.join(out_dir, "world1"), device,
                           loggers=MetricLoggers())
    metrics, counts, sec, shapes = dp_steps(torch, trainer, DP_STEPS)
    memory = ma_rest_memory(torch, device)
    steady = ma_steady_ms(torch, trainer, MA_STEADY)
    torch.save({"metrics": metrics, "counts": counts, "s": sec, "shapes": shapes, "memory": memory,
                "steady_ms": steady}, os.path.join(out_dir, "world1.pt"))


def ma_train_rank(rank, world, init_file, data_dir, out_dir):
    """One rank of the model-axis phase (a), in a process of its own: gloo
    over CUDA tensors, ``trainer.num_model_shards`` = ``MA_SHARDS``, the
    Trainer's steps on its rows of each global batch with the gather and
    the gradient reduction timed around each call (the card synchronized
    before and after); then a checkpoint (rank 0 writes it), the gathered
    state, and ``MA_STEADY`` steps timed with the collective timers off.
    Writes its metrics, counts, bytes, state and times."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bio_diffusion_torch.parallel import distributed, mesh
    from bio_diffusion_torch.train import loop
    from bio_diffusion_torch.train.state import MOMENTS, TrainState
    from bio_diffusion_torch.utils.logging import MetricLoggers

    dp = distributed.init_distributed(device=torch.device("cuda", 0), backend="gloo",
                                      init_method=f"file://{init_file}", rank=rank, world=world,
                                      timeout_s=DP_TIMEOUT_S, num_model_shards=MA_SHARDS)
    timings, timers_on = {"gather_": [], "reduce_gradients": []}, [True]

    def timed(name):
        fn = getattr(mesh.ModelShards, name)

        def wrapped(*args, **kwargs):
            if not timers_on[0]:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timings[name].append(1e3 * (time.perf_counter() - t0))
            return out
        setattr(mesh.ModelShards, name, wrapped)

    for name in timings:
        timed(name)
    mem, shard_ = {}, TrainState.shard_

    def measured_shard_(self, *args, **kwargs):
        torch.cuda.synchronize()
        mem["full_state"] = torch.cuda.memory_allocated()
        shard_(self, *args, **kwargs)
        torch.cuda.synchronize()
        mem["sharded"] = torch.cuda.memory_allocated()

    TrainState.shard_ = measured_shard_
    trainer = loop.Trainer(dp_experiment(data_dir), os.path.join(out_dir, f"rank{rank}"), dp.device,
                           loggers=MetricLoggers(), dp=dp)
    metrics, counts, sec, shapes = dp_steps(torch, trainer, DP_STEPS)
    step_timings = {name: list(ts) for name, ts in timings.items()}
    mem.update(ma_rest_memory(torch, dp.device))
    st = trainer.state
    copies = [st.param_shards, st.ema_shards] + [getattr(st, key) for key in MOMENTS]
    sharded, replicated = st.shards.sharded, st.shards.replicated
    elements = [p.numel() for p in st.params]
    result = {
        "rank": dp.rank, "world": dp.world, "mesh": (dp.data, dp.model), "collectives": st.shards.describe(),
        "metrics": metrics, "counts": counts, "s": sec, "shapes": shapes, "timings": step_timings, "memory": mem,
        "copies_bytes": sum(t.untyped_storage().nbytes() for ts in copies for t in ts),
        "released_bytes": sum(st.params[i].untyped_storage().nbytes() + st.ema_params[i].untyped_storage().nbytes()
                              for i in sharded),
        "world1_bytes": 5 * 4 * sum(elements),
        "expected_bytes": 5 * 4 * (sum(elements[i] for i in replicated) + sum(elements[i] for i in sharded)
                                   // MA_SHARDS),
        "sharded_leaves": len(sharded), "replicated_leaves": len(replicated)}
    trainer.save()  # step_3.pt, rank 0's workdir
    with st.gathered():
        result["params"] = [p.detach().cpu() for p in st.params]
        result["ema"] = [p.detach().cpu() for p in st.ema_params]
    result["moments"] = {key: [t.cpu() for t in ts] for key, ts in st.full_moments().items()}
    timers_on[0] = False
    result["steady_ms"] = ma_steady_ms(torch, trainer, MA_STEADY)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


def drive_model_axis(torch, data_dir, reference):
    """The model-axis phase: (a) ``MA_WORLD`` ranks, processes on one card
    laid out as 2 data groups x ``MA_SHARDS`` model shards, the Trainer's
    ``DP_STEPS`` steps at full QM9 width (fp32, global B=64, N=29) held
    against the data-parallel phase's one process (``reference``) on the
    same batches and seed; bytes of the five state copies at rest beside
    world 1's in a process of its own, the gather and gradient-reduction ms
    a step, the ms a step after a warm-up; the checkpoint of step 3
    restored at world 1 equal to the gathered state; (b) ``cli.train``
    under ``torch.distributed.run`` at world 2 with
    ``trainer.num_model_shards=2`` over NCCL where there are two cards ->
    (launches by path of the forward and backward kernels, numbers)."""
    from bio_diffusion_torch.train.loop import Trainer
    from bio_diffusion_torch.train.state import MOMENTS
    from bio_diffusion_torch.utils.logging import MetricLoggers

    root = os.path.join(REPO, "outputs", "model_axis")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out, numbers = {"fwd": {}, "bwd": {}}, {}
    t0 = time.perf_counter()
    run_ranks(ma_world1, 1, (data_dir, root))
    numbers["world1_s"] = time.perf_counter() - t0
    w1 = torch.load(os.path.join(root, "world1.pt"), weights_only=False)
    t0 = time.perf_counter()
    run_ranks(ma_train_rank, MA_WORLD, (os.path.join(root, "store"), data_dir, root))
    numbers["ranks_s"] = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(MA_WORLD)]
    need, rows = reference["layers"] * DP_STEPS, 64 // MA_WORLD
    w1_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for a, b in zip(w1["metrics"], reference["metrics"])
                 for k in ("loss", "grad_norm"))
    if w1_rel > TOL_DP_REL or w1["counts"]["message_layer"] != need or w1["counts"]["message_layer_bwd"] != need:
        raise AssertionError(f"world 1 in a process of its own is not the one process: {w1['metrics']}, "
                             f"{w1['counts']}")
    print(f"model axis (a) world 1 (a process of its own, the same {DP_STEPS} steps, loss and grad norm within rel "
          f"{w1_rel:.3g} of the one process's): memory_allocated {w1['memory']['at_rest']:,} B at rest after step {DP_STEPS} "
          f"({w1['memory']['at_rest_settled']:,} B after one more allocation); {MA_STEADY} steps after them "
          f"{[round(t, 3) for t in w1['steady_ms']]} ms")
    print(f"model axis (a): {MA_WORLD} ranks on one card as {ranks[0]['mesh'][0]} data x {ranks[0]['mesh'][1]} "
          f"model ({ranks[0]['collectives']}, CUDA tensors); {ranks[0]['sharded_leaves']} leaves sharded, "
          f"{ranks[0]['replicated_leaves']} replicated")
    for rk in ranks:
        c, m, tm = rk["counts"], rk["memory"], rk["timings"]
        print(f"model axis (a) rank {rk['rank']}: denoiser rows {rk['shapes']}, launches fwd {c['message_layer']} "
              f"bwd {c['message_layer_bwd']} (need {need} and {need}), {DP_STEPS} steps in {rk['s']:.3f} s "
              f"({1e3 * rk['s'] / DP_STEPS:.3f} ms a step); gather ms {[round(t, 3) for t in tm['gather_']]}, "
              f"gradient reduce-scatter + all-reduce ms {[round(t, 3) for t in tm['reduce_gradients']]}; the five "
              f"state copies at rest {rk['copies_bytes']:,} B of tensor storage (world 1: {rk['world1_bytes']:,} B; "
              f"expected replicated + sharded/{MA_SHARDS} = {rk['expected_bytes']:,} B), released parameters "
              f"{rk['released_bytes']} B; memory_allocated {m['full_state']:,} B with the full state, "
              f"{m['sharded']:,} B sharded, {m['at_rest']:,} B at rest after step {DP_STEPS} "
              f"({m['at_rest_settled']:,} B after one more allocation; world 1 "
              f"{w1['memory']['at_rest']:,} B, difference {m['at_rest'] - w1['memory']['at_rest']:,} B, the "
              f"copies' {rk['expected_bytes'] - rk['world1_bytes']:,} B); {MA_STEADY} steps after them "
              f"{[round(t, 3) for t in rk['steady_ms']]} ms")
        if c["message_layer"] != need or c["message_layer_bwd"] != need or rk["shapes"] != [(rows, 29)] * DP_STEPS:
            raise AssertionError(f"model axis rank {rk['rank']}: launches {c} or rows {rk['shapes']} not as planned")
        if rk["copies_bytes"] != rk["expected_bytes"] or rk["released_bytes"] != 0 \
                or m["full_state"] - m["sharded"] <= 0:
            raise AssertionError(f"model axis rank {rk['rank']}: the state at rest is not replicated + sharded/"
                                 f"{MA_SHARDS}, or the full parameters were not released")
        out["fwd"][f"ma_train_rank{rk['rank']}"] = c["message_layer"]
        out["bwd"][f"ma_train_rank{rk['rank']}"] = c["message_layer_bwd"]
    r0 = ranks[0]
    for rk in ranks[1:]:
        if rk["metrics"] != r0["metrics"] or not all(torch.equal(p, q) for p, q in zip(rk["params"], r0["params"])):
            raise AssertionError(f"model axis rank {rk['rank']}: metrics or gathered parameters differ from rank 0's")
    worst = 0.0
    for s, (a, b) in enumerate(zip(r0["metrics"], reference["metrics"])):
        for k in ("loss", "grad_norm"):
            rel = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            worst = max(worst, rel)
            if rel > TOL_DP_REL:
                raise AssertionError(f"model axis step {s} {k}: {a[k]} vs one process {b[k]} (rel {rel:.3g})")
    diffs = torch.cat([(p - q).abs().flatten() for p, q in zip(r0["params"], reference["params"])])
    param_tol = 2 * reference["lr"] * DP_STEPS
    max_diff, median_diff = float(diffs.max()), float(diffs.median())
    print(f"model axis (a): per-step loss and grad norm {r0['metrics']} vs one process {reference['metrics']} "
          f"(worst rel {worst:.3g}, tol {TOL_DP_REL}); gathered parameters max |diff| {max_diff:.3g} (tol 2 lr "
          f"steps = {param_tol:.3g}), median {median_diff:.3g}; every rank's equal to rank 0's")
    if max_diff > param_tol or median_diff > 1e-3 * reference["lr"]:
        raise AssertionError("the model-axis ranks' parameters are not the one process's")

    # the checkpoint of step 3, restored at world 1, is the gathered state
    restored = Trainer(dp_experiment(data_dir), os.path.join(root, "rank0"), "cuda", loggers=MetricLoggers())
    st = restored.init_state()
    pairs = [(st.params, r0["params"]), (st.ema_params, r0["ema"])] + [
        (getattr(st, key), r0["moments"][key]) for key in MOMENTS]
    same = st.count == DP_STEPS and all(torch.equal(p.detach().cpu(), q) for a, b in pairs for p, q in zip(a, b))
    print(f"model axis (a): checkpoint step_{restored.start_step}.pt restored at world 1 bit-equal to the gathered "
          f"parameters, EMA and moments: {same}")
    if not same:
        raise AssertionError("the model-axis checkpoint does not restore the gathered state at world 1")
    del restored, st

    steady = [t for rk in ranks for t in rk["timings"]["gather_"][1:]]
    reduce = [t for rk in ranks for t in rk["timings"]["reduce_gradients"][1:]]
    numbers.update(world=MA_WORLD, mesh=list(r0["mesh"]), collectives=r0["collectives"], steps=DP_STEPS,
                   step_ms=[1e3 * rk["s"] / DP_STEPS for rk in ranks],
                   one_process_step_ms=1e3 * reference["s"] / DP_STEPS,
                   steady_step_ms=statistics.mean(t for rk in ranks for t in rk["steady_ms"]),
                   world1_steady_step_ms=statistics.mean(w1["steady_ms"]), world1_memory=w1["memory"],
                   gather_ms_per_step=statistics.mean(steady), reduce_ms_per_step=statistics.mean(reduce),
                   gather_ms_first=[rk["timings"]["gather_"][0] for rk in ranks],
                   reduce_ms_first=[rk["timings"]["reduce_gradients"][0] for rk in ranks],
                   copies_bytes=r0["copies_bytes"], world1_bytes=r0["world1_bytes"],
                   expected_bytes=r0["expected_bytes"], memory_allocated=[rk["memory"] for rk in ranks],
                   max_rel_err=worst, param_max_abs_diff=max_diff, param_median_abs_diff=median_diff)
    print(f"model axis (a): gather {numbers['gather_ms_per_step']:.3f} ms and gradient reduction "
          f"{numbers['reduce_ms_per_step']:.3f} ms a step (mean of steps 2-{DP_STEPS} of the {MA_WORLD} ranks; "
          f"{MA_WORLD} ranks on one card, gloo: no scaling figure), ms a step by rank "
          f"{[round(t, 3) for t in numbers['step_ms']]} (the first {DP_STEPS} steps of a fresh process, "
          f"collective timers included; the one process {1e3 * reference['s'] / DP_STEPS:.3f} ms on that basis); "
          f"after them, timers off: {numbers['steady_step_ms']:.3f} ms a step (mean of {MA_STEADY} steps of the "
          f"{MA_WORLD} ranks), world 1 {numbers['world1_steady_step_ms']:.3f} ms")

    # (b) cli.train at world 2 with two model shards over NCCL, on two cards
    if torch.cuda.device_count() >= 2:
        cli_ranks, numbers["cli_2_s"] = drive_dp_cli(torch, data_dir, root, 2, model=2)
        out["fwd"]["ma_cli"] = sum(rk["counts"]["message_layer"] for rk in cli_ranks)
        out["bwd"]["ma_cli"] = sum(rk["counts"]["message_layer_bwd"] for rk in cli_ranks)
    else:
        print("model axis (b): one card, so no cli.train run at world 2 with trainer.num_model_shards=2 over NCCL")
    return out, numbers


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    if not os.path.isdir(os.path.join(REPO, "bio_diffusion_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the repository")
    if sys.argv[1:2] == ["--dp-cli"]:  # a rank of the data-parallel phase's torch.distributed.run
        return dp_cli_rank(sys.argv[2], sys.argv[3:])
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from bio_diffusion_torch.cli.common import load_model
    from bio_diffusion_torch.ops import build

    sources = ("message_layer", "message_layer_bwd", "gcp2_chain", "elementwise_passes")
    t0 = time.perf_counter()
    build.load_libraries(*sources)
    print(f"built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  nvcc {name}: {line.strip()}")

    evd_kernels = load_model(qm9_experiment("bf16"), None, torch.device("cuda"), seed=0)
    occupancy = kernel_occupancy(torch, evd_kernels)
    occupancy_bwd = bwd_occupancy(torch, evd_kernels)
    kernel = check_kernel(torch, evd_kernels)
    kernel_bwd = check_bwd_kernel(torch, evd_kernels)
    chain = check_chain(torch, evd_kernels)
    chain_launches, unfused = drive_unfused(torch, evd_kernels)
    del evd_kernels
    check_denoiser(torch)
    check_denoiser_grad(torch)
    serve_launches, step_ms_b250 = drive_main_path(torch, kernel["by_shape"]["bf16, B=250, N=19"]["ms"])
    train_counts, step_ms = drive_training(torch, "fp32", steps=10, timed_steps=6)
    train_counts_bf16, step_ms_bf16 = drive_training(torch, "bf16", steps=3, timed_steps=4)
    for prec, ms, kind in (("fp32", step_ms, "float32"), ("bf16", step_ms_bf16, "bfloat16")):
        share = 9 * (kernel_bwd["fwd_ms_b64"][kind] + kernel_bwd["bwd_ms_b64"][kind]) / ms
        print(f"train {prec}: the two kernels at B=64, N=29 (9 x (fwd + bwd), timed alone) "
              f"= {100 * share:.1f}% of the step")
    train_fwd = train_counts["message_layer"] + train_counts_bf16["message_layer"]
    train_bwd = train_counts["message_layer_bwd"] + train_counts_bf16["message_layer_bwd"]
    t0 = time.perf_counter()
    user_launches, user_numbers = drive_user_path(torch)
    print(f"user path phase: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    dp_launches, dp_numbers, one_process = drive_data_parallel(torch, os.path.join(REPO, "outputs", "user_path",
                                                                                   "data"))
    dp_numbers["phase_s"] = time.perf_counter() - t0
    print(f"data parallel phase: {dp_numbers['phase_s']:.3f} s")
    t0 = time.perf_counter()
    ma_launches, ma_numbers = drive_model_axis(torch, os.path.join(REPO, "outputs", "user_path", "data"), one_process)
    ma_numbers["phase_s"] = time.perf_counter() - t0
    print(f"model axis phase: {ma_numbers['phase_s']:.3f} s")
    for key in ("fwd", "bwd"):  # the model axis's launches join the data-parallel paths'
        dp_launches[key].update(ma_launches[key])
    t0 = time.perf_counter()
    sc_launches, sc_numbers = drive_sc_learned_path(torch, os.path.join(REPO, "outputs", "user_path", "data"))
    sc_numbers["phase_s"] = time.perf_counter() - t0
    print(f"self-conditioning and learned schedule phase: {sc_numbers['phase_s']:.3f} s")
    t0 = time.perf_counter()
    mp_launches, mp_numbers = drive_module_paths(torch, os.path.join(REPO, "outputs", "user_path", "data"))
    mp_numbers["phase_s"] = time.perf_counter() - t0
    print(f"module-path denoisers phase: {mp_numbers['phase_s']:.3f} s")
    t0 = time.perf_counter()
    tools_launches, tools_numbers = drive_tools(torch, os.path.join(REPO, "outputs", "user_path", "data"))
    tools_numbers["phase_s"] = time.perf_counter() - t0
    print(f"tools phase: {tools_numbers['phase_s']:.3f} s")
    t0 = time.perf_counter()
    cond_launches, cond_numbers = drive_conditional_path(torch, os.path.join(REPO, "outputs", "user_path", "data"))
    cond_numbers["phase_s"] = time.perf_counter() - t0
    print(f"conditional path phase: {cond_numbers['phase_s']:.3f} s")
    t0 = time.perf_counter()
    geom_launches, geom_fwd, geom_bwd = drive_geom_path(torch)
    geom_fwd["phase_s"] = time.perf_counter() - t0
    print(f"GEOM path phase: {geom_fwd['phase_s']:.3f} s")
    t0 = time.perf_counter()
    pocket_launches, pocket_numbers = drive_pocket_path(torch)
    pocket_numbers["phase_s"] = time.perf_counter() - t0
    print(f"pocket path phase: {pocket_numbers['phase_s']:.3f} s")
    new_paths = {}
    for name, drive in (
            ("chain path", drive_chain_path),
            ("sweep path", lambda t: drive_sweep_path(t, os.path.join(REPO, "outputs", "user_path", "data"),
                                                      os.path.join(REPO, "outputs", "conditional_path", "train",
                                                                   "checkpoints"))),
            ("serving benchmarks", drive_serving_benchmarks),
            ("debug and profile", drive_debug_and_profile)):
        t0 = time.perf_counter()
        launches, numbers = drive(torch)
        numbers["phase_s"] = time.perf_counter() - t0
        print(f"{name} phase: {numbers['phase_s']:.3f} s")
        new_paths[name] = (launches, numbers)
    new_fwd = {k: v for launches, _ in new_paths.values() for k, v in launches["fwd"].items()}
    new_bwd = {k: v for launches, _ in new_paths.values() for k, v in launches.get("bwd", {}).items()}
    t0 = time.perf_counter()
    passes_err, passes_launches, probe = check_passes(torch)
    passes_phase_s = time.perf_counter() - t0
    print(f"pass probe phase: {passes_phase_s:.3f} s")

    # the chain row: bf16 at the training shape's E, float32 and the serving
    # shape's E beside it
    chain_row = chain[("bfloat16", 53824)]
    # the probe's row: one launch of 104 mul passes over its [90250, 256]
    # array, and one pass beside the one torch.mul call for it
    probe_row = dict(passes_row(torch, probe), phase_s=passes_phase_s)
    print(json.dumps({"kernels": [{
        "name": "message_layer",
        "route": "cuda",
        "source": "bio_diffusion_torch/csrc/message_layer.cu",
        "replaces": "bio_diffusion_tpu/ops/pallas/gcp_kernel.py:619",
        "launches": serve_launches + train_fwd + sum(user_launches["fwd"].values()) + sum(dp_launches["fwd"].values())
        + sum(sc_launches["fwd"].values()) + sum(mp_launches["fwd"].values()) + sum(tools_launches["fwd"].values())
        + sum(cond_launches["fwd"].values()) + sum(geom_launches["fwd"].values())
        + sum(pocket_launches["fwd"].values()) + sum(new_fwd.values()),
        "launches_by_path": {"serve": serve_launches, "train": train_fwd, **user_launches["fwd"], **dp_launches["fwd"],
                             **sc_launches["fwd"], **mp_launches["fwd"], **tools_launches["fwd"], **cond_launches["fwd"],
                             **geom_launches["fwd"],
                             **pocket_launches["fwd"], **new_fwd},
        "max_abs_err": kernel["max_abs_err"],
        "max_rel_err": kernel["max_rel_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": None,
        "shape": "bf16, B=8, N=19",
        "by_shape": kernel["by_shape"],
        "ms_b64": kernel_bwd["fwd_ms_b64"],
        "bound_ms_b64": kernel_bwd["fwd_bound_ms_b64"],
        "reverse_step_ms_b250": step_ms_b250,
        "user_path": user_numbers,
        "data_parallel": dp_numbers,
        "model_axis": ma_numbers,
        "sc_learned_path": sc_numbers,
        "module_path": mp_numbers,
        "tools": tools_numbers,
        "conditional_path": cond_numbers,
        "geom": geom_fwd,
        "pocket": pocket_numbers,
        **{name.replace(" ", "_"): numbers for name, (_, numbers) in new_paths.items()},
        "smem_bytes_blocks_per_sm": occupancy["message_layer"],
    }, {
        "name": "message_layer_bwd",
        "route": "cuda",
        "source": "bio_diffusion_torch/csrc/message_layer_bwd.cu",
        "replaces": "bio_diffusion_tpu/ops/pallas/gcp_kernel.py:1142",
        "launches": train_bwd + sum(user_launches["bwd"].values()) + sum(dp_launches["bwd"].values())
        + sum(sc_launches["bwd"].values()) + sum(mp_launches["bwd"].values()) + sum(tools_launches["bwd"].values())
        + sum(cond_launches["bwd"].values())
        + sum(geom_launches["bwd"].values()) + sum(pocket_launches["bwd"].values()) + sum(new_bwd.values()),
        "launches_by_path": {"train": train_bwd, **user_launches["bwd"], **dp_launches["bwd"], **sc_launches["bwd"],
                             **mp_launches["bwd"], **tools_launches["bwd"], **cond_launches["bwd"],
                             **geom_launches["bwd"], **pocket_launches["bwd"], **new_bwd},
        "max_abs_err": kernel_bwd["max_abs_err"],
        "max_rel_err": kernel_bwd["max_rel_err"],
        "max_abs_err_bf16": kernel_bwd["max_abs_err_bf16"],
        "max_rel_err_bf16": kernel_bwd["max_rel_err_bf16"],
        "ms": kernel_bwd["ms"],
        "plain_ms": kernel_bwd["plain_ms"],
        "bound_ms": kernel_bwd["bound_ms"],
        "bound_by": kernel_bwd["bound_by"],
        "library_ms": None,
        "shape": "fp32, B=64, N=29",
        "ms_bf16": kernel_bwd["ms_bf16"],
        "plain_ms_bf16": kernel_bwd["plain_ms_bf16"],
        "bound_ms_bf16": kernel_bwd["bound_ms_bf16"],
        "sub_kernels": {"fp32": kernel_bwd["sub_kernels_float32"], "bf16": kernel_bwd["sub_kernels_bfloat16"]},
        "reductions_alone": kernel_bwd["reductions_alone"],
        "occupancy": occupancy_bwd,
        "geom": geom_bwd,
    }, {
        "name": "gcp2_chain",
        "route": "cuda",
        "source": "bio_diffusion_torch/csrc/gcp2_chain.cu",
        "replaces": "bio_diffusion_tpu/ops/pallas/gcp_kernel.py:204",
        "launches": chain_launches,
        "launches_by_path": {"unfused_message_passing": chain_launches},
        "max_abs_err": chain_row["max_abs_err"],
        "max_rel_err": chain_row["max_rel_err"],
        "ms": chain_row["ms"],
        "plain_ms": chain_row["plain_ms"],
        "bound_ms": chain_row["bound_ms"],
        "bound_by": chain_row["bound_by"],
        "library_ms": None,
        "shape": "bf16, E=53824",
        "by_shape": {f"{dt}, E={e}": r for (dt, e), r in chain.items()},
        "unfused_layer_ms": unfused,
        "smem_bytes_blocks_per_sm": occupancy["gcp2_chain"],
    }, {
        "name": "elementwise_passes",
        "route": "cuda",
        "source": "bio_diffusion_torch/csrc/elementwise_passes.cu",
        "replaces": "scripts/bench_vpu_passes.py:67",
        "launches": passes_launches,
        "launches_by_path": {"bench_passes": passes_launches},
        "max_abs_err": passes_err,
        **probe_row,
        "shape": f"mul, k=104 (ms_k1, library_ms: k=1), [{probe['rows']}, {probe['cols']}] float32",
        "accounted_ms": probe["accounted_ms"],
        "message_layer_ms": probe["message_layer_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
