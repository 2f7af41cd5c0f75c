"""Resident molecule-generation server on one device, or with each batch
split over several (``devices``, the JAX server's ``mesh``).

Port of ``bio_diffusion_tpu/serve.py::MoleculeServer``: transport threads
enqueue per-molecule jobs; one executor thread owns the device and runs
fixed-shape ``(batch_size, bucket)`` batches, taking the LARGEST pending
molecules first (device cost grows ~N^2 with the batch's padded bucket), with
a linger (``max_wait_ms``) for partial batches and an age bound
(``max_job_age_s``) past which a job rides the next batch regardless of size.

Determinism contract: a request with an explicit ``seed`` runs alone, draws
its molecule sizes from ``np.random.default_rng(seed)`` and its noise from a
``torch.Generator`` seeded with ``seed`` on the serving device, so the same
request on the same device returns the same molecules.  Seedless requests
share batches and draw from the server's streams.
"""

from __future__ import annotations

import bisect
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from bio_diffusion_torch.chem.stability import batch_molecular_stability, ensure_bond_tables
from bio_diffusion_torch.train.sampling import SegmentedSampler, make_node_mask

_SHUTDOWN = object()  # executor shutdown sentinel


def _bucket_for(size: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if size <= b:
            return int(b)
    return int(buckets[-1])


@dataclass
class _Job:
    """One molecule to generate (a request fans out into jobs)."""

    size: int
    num_timesteps: Optional[int]
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[BaseException] = None
    t_enq: float = field(default_factory=time.time)
    # set on every job of a seeded request: the request runs as one exclusive
    # batch with a generator seeded from ``seed``
    seed: Optional[int] = None
    group: Optional[List["_Job"]] = None


class MoleculeServer:
    """Serve molecule generation from one model on one torch device.

    Parameters
    ----------
    evd : the port's EquivariantVariationalDiffusion, already on ``device``
    dataset_info : registry entry (atom decoder, bond tables, histograms)
    nodes_dist : NumNodesDistribution for requests without ``num_nodes``
    device : the torch device every batch runs on (the first of ``devices``)
    devices : optional list of devices each batch is split over (a replica
        of ``evd`` on each; ``train.sampling.SegmentedSampler``); the same
        seed gives the same molecules as on ``device`` alone
    batch_size : fixed device batch; every executed batch has this shape
    buckets : node-count ladder; default multiples of 2 up to the dataset max
    num_timesteps : default denoising steps (None = the model's T)
    """

    def __init__(
        self,
        evd,
        dataset_info: Dict[str, Any],
        nodes_dist,
        *,
        device,
        devices: Optional[Sequence] = None,
        batch_size: int = 8,
        buckets: Optional[Sequence[int]] = None,
        num_timesteps: Optional[int] = None,
        max_wait_ms: float = 5.0,
        max_job_age_s: float = 30.0,
        seed: int = 0,
        max_request_mols: int = 10_000,
    ):
        self.device = torch.device(device)
        self.devices = [torch.device(d) for d in devices] if devices else [self.device]
        self.dataset_info = ensure_bond_tables(dict(dataset_info))
        self.nodes_dist = nodes_dist
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_job_age_s = float(max_job_age_s)
        self.default_T = num_timesteps
        max_n = int(dataset_info["max_n_nodes"])
        if buckets is None:
            buckets = {min(b, max_n) for b in range(2, max_n + 2, 2)}
        self.buckets = sorted(int(b) for b in buckets)
        self.include_charges = bool(evd.include_charges)
        self.max_request_mols = int(max_request_mols)

        self.sampler = SegmentedSampler(evd, devices=self.devices)
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()  # generate() runs on transport threads
        self._generator = torch.Generator(device=self.device).manual_seed(int(seed))

        self._queue: "queue.Queue[Any]" = queue.Queue()
        self._running = True
        self.stats: Dict[str, Any] = {
            "requests": 0, "molecules": 0, "batches": 0,
            "batched_jobs": 0, "device_s": 0.0, "started": time.time(),
            "bucket_batches": {},
        }
        self._stats_lock = threading.Lock()
        self._executor = threading.Thread(target=self._run_loop, daemon=True)
        self._executor.start()

    # ------------------------------------------------------------- lifecycle
    def warmup(self, buckets: Optional[Sequence[int]] = None) -> List[int]:
        """Run one single-step batch per bucket: builds the kernels and warms
        the allocator and library handles before the first request."""
        warmed = []
        gen = torch.Generator(device=self.device).manual_seed(0)
        for b in buckets if buckets is not None else self.buckets:
            mask = make_node_mask(np.full(self.batch_size, int(b)), int(b))
            self.sampler.run(mask, gen, num_timesteps=1)
            warmed.append(int(b))
        return warmed

    def close(self):
        self._running = False
        self._queue.put(_SHUTDOWN)
        self._executor.join(timeout=10)
        err = RuntimeError("server closed")
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            if job is not _SHUTDOWN and not job.done.is_set():
                job.error = err
                job.done.set()

    # --------------------------------------------------------------- serving
    def generate(
        self,
        num_samples: int,
        num_nodes: Optional[int] = None,
        num_timesteps: Optional[int] = None,
        seed: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Generate ``num_samples`` molecules; blocks until done.  Thread-safe."""
        t0 = time.time()
        num_samples = int(num_samples)
        if not 1 <= num_samples <= self.max_request_mols:
            raise ValueError(
                f"num_samples must be in [1, {self.max_request_mols}], got {num_samples}"
            )
        if num_nodes:
            if int(num_nodes) > self.buckets[-1]:
                raise ValueError(
                    f"num_nodes={num_nodes} exceeds the largest bucket ({self.buckets[-1]})"
                )
            sizes = np.full(num_samples, int(num_nodes), dtype=np.int64)
        elif seed is not None:
            sizes = self.nodes_dist.sample(num_samples, np.random.default_rng(seed))
        else:
            with self._rng_lock:
                sizes = self.nodes_dist.sample(num_samples, self._rng)
        sizes = np.minimum(sizes, self.buckets[-1])
        T = int(num_timesteps) if num_timesteps else self.default_T
        jobs = [_Job(size=int(s), num_timesteps=T, seed=seed) for s in sizes]
        if seed is not None:
            for j in jobs:
                j.group = jobs
        for j in jobs:
            self._queue.put(j)
        mols = []
        for j in jobs:
            if not j.done.wait(timeout):
                raise TimeoutError("generation timed out")
            if j.error is not None:
                raise j.error
            mols.append(j.result)
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["molecules"] += len(mols)
        return {
            "molecules": mols,
            "num_molecules": len(mols),
            "mol_stable_frac": float(np.mean([m["stable"] for m in mols])) if mols else 0.0,
            "elapsed_s": round(time.time() - t0, 4),
        }

    # -------------------------------------------------------------- executor
    def _run_loop(self):
        # Size-sorted micro-batcher: pending jobs pooled per num_timesteps,
        # kept sorted by size (desc); a batch is the batch_size LARGEST jobs
        # of a pool, run at once when they share one bucket and otherwise when
        # the linger expires; jobs older than max_job_age_s are force-included.
        pending: Dict[Any, List[_Job]] = {}

        def take(T) -> List[_Job]:
            grp = pending.pop(T)
            if len(grp) <= self.batch_size:
                return grp
            now = time.time()
            forced = [j for j in grp if now - j.t_enq > self.max_job_age_s]
            if forced:
                grp = forced + [j for j in grp if now - j.t_enq <= self.max_job_age_s]
            jobs, rest = grp[: self.batch_size], grp[self.batch_size:]
            if forced:
                rest.sort(key=lambda j: -j.size)
            pending[T] = rest
            return jobs

        def coherent_full_pool():
            for T, grp in pending.items():
                if len(grp) >= self.batch_size and _bucket_for(
                    grp[0].size, self.buckets
                ) == _bucket_for(grp[self.batch_size - 1].size, self.buckets):
                    return T
            return None

        def run_seeded(sj: _Job, local_ids: set):
            """Run one seeded request alone; pull its members still queued
            (handing other jobs back)."""
            batch = [j for j in sj.group if not j.done.is_set()]
            remaining = {id(j) for j in batch} - {id(sj)} - local_ids
            deferred = []
            while remaining:
                nxt = self._queue.get()
                if nxt is _SHUTDOWN:
                    self._queue.put(_SHUTDOWN)
                    break
                if id(nxt) in remaining:
                    remaining.discard(id(nxt))
                else:
                    deferred.append(nxt)
            for d in deferred:
                self._queue.put(d)
            gen = torch.Generator(device=self.device).manual_seed(int(sj.seed))
            self._execute(batch, gen)

        def fail(jobs, err):
            for j in jobs:
                if not j.done.is_set():
                    j.error = err
                    j.done.set()

        shutdown = False
        while self._running and not shutdown:
            if pending:
                oldest = min(j.t_enq for grp in pending.values() for j in grp)
                timeout = max(0.0, oldest + self.max_wait_s - time.time())
            else:
                timeout = None
            items: List[Any] = []
            try:
                items.append(self._queue.get(timeout=timeout))
            except queue.Empty:
                pass  # linger expired
            while True:
                try:
                    items.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            seeded = [it for it in items if it is not _SHUTDOWN and it.group is not None]
            local_ids = {id(s) for s in seeded}
            for it in items:
                if it is _SHUTDOWN:
                    shutdown = True
                elif it.group is None:
                    bisect.insort(pending.setdefault(it.num_timesteps, []), it,
                                  key=lambda j: -j.size)
            for sj in seeded:
                if sj.done.is_set():
                    continue
                try:
                    run_seeded(sj, local_ids)
                except Exception as e:  # noqa: BLE001 — handed to the waiting callers
                    fail(sj.group, e)
            if shutdown:
                break
            if not pending:
                continue
            now = time.time()
            aged = [(j.t_enq, T) for T, grp in pending.items() for j in grp
                    if now - j.t_enq > self.max_job_age_s]
            run_key = min(aged)[1] if aged else coherent_full_pool()
            if run_key is None:
                oldest_t = min(j.t_enq for grp in pending.values() for j in grp)
                if time.time() < oldest_t + self.max_wait_s:
                    continue
                run_key = min(pending, key=lambda k: min(j.t_enq for j in pending[k]))
            batch = take(run_key)
            try:
                self._execute(batch, self._generator)
            except Exception as e:  # noqa: BLE001 — handed to the waiting callers
                fail(batch, e)
        err = RuntimeError("server closed")
        for grp in pending.values():
            fail(grp, err)

    def _execute(self, jobs: List[_Job], generator: torch.Generator):
        for start in range(0, len(jobs), self.batch_size):
            self._execute_chunk(jobs[start: start + self.batch_size], generator)

    def _execute_chunk(self, jobs: List[_Job], generator: torch.Generator):
        sizes = [j.size for j in jobs]
        bucket = _bucket_for(max(sizes), self.buckets)
        # pad the batch with copies of the last size: the shape is always
        # (batch_size, bucket); the extra molecules are discarded
        padded = sizes + [sizes[-1]] * (self.batch_size - len(sizes))
        mask = make_node_mask(np.asarray(padded), bucket)
        t0 = time.time()
        xh = self.sampler.run(mask, generator, num_timesteps=jobs[0].num_timesteps)
        device_s = time.time() - t0
        k = len(self.dataset_info["atom_decoder"])
        atom_types = xh[..., 3: 3 + k].argmax(-1)
        mol_stable, _, _ = batch_molecular_stability(xh[..., :3], atom_types, mask, self.dataset_info)
        decoder = self.dataset_info["atom_decoder"]
        for i, j in enumerate(jobs):
            m = mask[i] > 0
            result = {
                "atoms": [decoder[int(t)] for t in atom_types[i][m]],
                "positions": np.round(xh[i, :, :3][m], 6).tolist(),
                "size": int(m.sum()),
                "stable": bool(mol_stable[i]),
            }
            if self.include_charges:
                result["charges"] = np.round(xh[i, :, 3 + k][m]).astype(int).tolist()
            j.result = result
            j.done.set()
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["batched_jobs"] += len(jobs)
            self.stats["device_s"] += device_s
            bb = self.stats["bucket_batches"]
            bb[bucket] = bb.get(bucket, 0) + 1

    # ----------------------------------------------------------------- intro
    def describe(self) -> Dict[str, Any]:
        with self._stats_lock:
            stats = dict(self.stats)
            stats["bucket_batches"] = dict(stats["bucket_batches"])
        stats["uptime_s"] = round(time.time() - stats.pop("started"), 1)
        stats["avg_batch_occupancy"] = round(stats["batched_jobs"] / max(stats["batches"], 1), 3)
        device = ", ".join(str(d) for d in self.devices)
        if self.device.type == "cuda":
            device += f" ({torch.cuda.get_device_name(self.device)})"
        return {
            "status": "ok",
            "device": device,
            "batch_size": self.batch_size,
            "buckets": self.buckets,
            "default_num_timesteps": self.default_T or int(self.sampler.evd.T),
            "stats": stats,
        }
