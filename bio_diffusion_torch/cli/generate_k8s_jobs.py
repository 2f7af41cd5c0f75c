"""Generate schedulable Kubernetes GPU Job YAMLs from a grid-search manifest
or a single experiment (counterpart of ``scripts/generate_k8s_jobs.py``,
which writes TPU Jobs, and of the reference's
scripts/nautilus/generate_*_grid_search_jobs.py + gpu_job_template.yaml).

Usage:
  # one Job per grid-search run (cli.generate_grid_search_runs):
  python -m bio_diffusion_torch.cli.generate_k8s_jobs --manifest out_dir/grid_manifest.json \\
      --out-dir out_dir/k8s [--image IMG] [--num-hosts 1] [--gpus-per-host 8] \\
      [--gpu-product NVIDIA-H100-80GB-HBM3] [--pvc NAME]

  # a single experiment Job:
  python -m bio_diffusion_torch.cli.generate_k8s_jobs --experiment qm9_mol_gen_ddpm \\
      --out-dir k8s/ [same flags]

Each Job runs one pod per host (``--num-hosts``), each asking for
``--gpus-per-host`` ``nvidia.com/gpu`` and running ``torchrun
--nnodes=<hosts> --nproc-per-node=<gpus> --node-rank=<the pod's completion
index> --master-addr=<pod 0> --master-port=29500 -m
bio_diffusion_torch.cli.train ...`` (the run's command with its ``python -m``
replaced); ``cli.train`` reads torchrun's variables and trains data-parallel
with one process a card.  ``--gpu-product`` adds a node selector on the
``nvidia.com/gpu.product`` label.  More than one host adds a headless
Service per Job for pod 0's name.  Also emits the PVC YAML (once) and an
``apply_all.sh``.  A template variable left unsubstituted raises.
"""

from __future__ import annotations

import json
import os
import re
import sys

TEMPLATE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "k8s")
MASTER_PORT = 29500

DEFAULTS = {
    "IMAGE": "gcr.io/my-project/bio-diffusion-torch:latest",
    "NUM_HOSTS": "1",
    "GPUS_PER_HOST": "8",
    "MEMORY": "200Gi",
    "CPU": "32",
    "PVC_NAME": "bio-diffusion-torch-pvc",
    "STORAGE": "200Gi",
    "STORAGE_CLASS": "standard-rwx",
}


def render(template: str, subs: dict) -> str:
    out = template
    # longest-first so that a key that prefixes another is not clobbered
    for key in sorted(subs, key=len, reverse=True):
        out = out.replace(f"${key}", str(subs[key]))
    leftover = sorted(set(re.findall(r"\$[A-Z_]+", out)))
    if leftover:
        raise ValueError(f"unsubstituted template variables: {leftover}")
    return out


def job_name(run_id: str) -> str:
    # RFC 1123: lowercase alphanumerics and '-'
    name = re.sub(r"[^a-z0-9-]+", "-", run_id.lower()).strip("-")
    return f"bio-diffusion-torch-{name}"[:63].rstrip("-")


def torchrun_command(cmd: str, job: str, num_hosts: int, gpus_per_host: int) -> str:
    """A run's ``python -m <module> ...`` as the torchrun line of one pod."""
    m = re.match(r"^\s*python3?\s+-m\s+", cmd)
    if not m:
        raise ValueError(f"a run's command must start with 'python -m <module>': {cmd!r}")
    master = f"{job}-0.{job}" if num_hosts > 1 else "localhost"
    return (f"torchrun --nnodes={num_hosts} --nproc-per-node={gpus_per_host} --node-rank=${{NODE_RANK}} "
            f"--master-addr={master} --master-port={MASTER_PORT} -m {cmd[m.end():]}")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)

    def opt(flag, default=None):
        if flag in argv:
            return argv[argv.index(flag) + 1]
        return default

    manifest_path = opt("--manifest")
    experiment = opt("--experiment")
    out_dir = opt("--out-dir")
    if not out_dir or not (manifest_path or experiment):
        print(__doc__)
        sys.exit(1)
    for flag in ("--chips-per-host", "--accelerator", "--topology"):
        if flag in argv:
            raise SystemExit(f"{flag} is a TPU flag; GPU Jobs take --gpus-per-host and --gpu-product")

    subs = dict(DEFAULTS)
    subs["IMAGE"] = opt("--image", subs["IMAGE"])
    subs["NUM_HOSTS"] = opt("--num-hosts", subs["NUM_HOSTS"])
    subs["GPUS_PER_HOST"] = opt("--gpus-per-host", subs["GPUS_PER_HOST"])
    subs["PVC_NAME"] = opt("--pvc", subs["PVC_NAME"])
    product = opt("--gpu-product")
    subs["NODE_SELECTOR"] = json.dumps({"nvidia.com/gpu.product": product} if product else {})
    num_hosts, gpus = int(subs["NUM_HOSTS"]), int(subs["GPUS_PER_HOST"])
    multihost = num_hosts > 1

    def template(name):
        with open(os.path.join(TEMPLATE_DIR, name)) as f:
            return f.read()

    job_tmpl = template("gpu_job_template.yaml")
    pvc_tmpl = template("persistent_storage_template.yaml")
    svc_tmpl = template("headless_service_template.yaml")

    runs = []
    if manifest_path:
        with open(manifest_path) as f:
            runs = [(entry["run_id"], entry["cmd"]) for entry in json.load(f)]
    else:
        runs.append((experiment, f"python -m bio_diffusion_torch.cli.train experiment={experiment} "
                                 f"--workdir=/data/runs/{experiment}"))

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    pvc_path = os.path.join(out_dir, "persistent_storage.yaml")
    with open(pvc_path, "w") as f:
        f.write(render(pvc_tmpl, subs))
    paths.append(pvc_path)

    for run_id, cmd in runs:
        name = job_name(run_id)
        rsubs = dict(subs, JOB_NAME=name, COMMAND=json.dumps(torchrun_command(cmd, name, num_hosts, gpus)))
        path = os.path.join(out_dir, f"job_{run_id}.yaml")
        with open(path, "w") as f:
            f.write(render(job_tmpl, rsubs))
        paths.append(path)
        if multihost:
            svc_path = os.path.join(out_dir, f"service_{run_id}.yaml")
            with open(svc_path, "w") as f:
                f.write(render(svc_tmpl, rsubs))
            paths.append(svc_path)

    apply_sh = os.path.join(out_dir, "apply_all.sh")
    with open(apply_sh, "w") as f:
        f.write("#!/bin/bash\nset -e\n")
        for p in paths:
            f.write(f"kubectl apply -f {os.path.basename(p)}\n")
    os.chmod(apply_sh, 0o755)
    print(f"wrote {len(paths)} YAMLs + apply_all.sh to {out_dir}")
    return paths


if __name__ == "__main__":
    main()
