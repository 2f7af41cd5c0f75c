"""The port's tools against the JAX package's: the metric loggers and the
service backends (through fake ``wandb`` / ``mlflow`` / ``comet_ml`` /
``neptune`` modules, so that both packages make their calls into the same
recorder), the config tree and tag enforcement, the gradient-flow summary,
the hyperparameter study, the grid-search manifest and monitor, the GPU k8s
Jobs, and ``analysis/*`` (psi4, crest and obabel faked as in
``test_analysis_extras.py``)."""

import csv
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from bio_diffusion_torch.utils import hparam as port_hparam
from bio_diffusion_torch.utils import logging as port_logging
from bio_diffusion_tpu.utils import hparam as jax_hparam
from bio_diffusion_tpu.utils import logging as jax_logging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
METRICS = [({"train/loss": 1.5, "train/grad_norm": 0.25, "note": "warm-up"}, 1, 0),
           ({"train/loss": 1.25, "val/loss": 2.0}, 2, 0),
           ({"val/mol_stable": 0.5}, 3, 1)]


def _script(name):
    sys.path.insert(0, SCRIPTS)
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _log_all(loggers):
    for metrics, step, epoch in METRICS:
        loggers.log(metrics, step=step, epoch=epoch)


def _without_time(rows):
    return [{k: v for k, v in r.items() if k != "time"} for r in rows]


# ---------------------------------------------------------------------------
# loggers
# ---------------------------------------------------------------------------


def test_local_loggers_write_what_jax_writes(tmp_path):
    """csv, jsonl and TensorBoard (``logger=many_loggers``) hold the same rows
    and scalars as the JAX package's for the same calls, the time aside; the
    event files read back by ``read_scalar_events`` match the CSV."""
    cfg = {"csv": {}, "tensorboard": {}, "jsonl": {}}
    out = {}
    for name, mod in (("jax", jax_logging), ("port", port_logging)):
        loggers = mod.build_loggers(cfg, str(tmp_path / name))
        assert [type(lg).__name__ for lg in loggers.loggers] == ["CSVLogger", "TensorBoardLogger", "JSONLLogger"]
        _log_all(loggers)
        loggers.finish()
        with open(tmp_path / name / "metrics.csv") as f:
            csv_rows = _without_time(list(csv.DictReader(f)))
        with open(tmp_path / name / "metrics.jsonl") as f:
            jsonl_rows = _without_time([json.loads(line) for line in f])
        out[name] = (csv_rows, jsonl_rows, port_logging.read_scalar_events(str(tmp_path / name / "tensorboard")))
    assert out["port"] == out["jax"]
    csv_rows, jsonl_rows, events = out["port"]
    want = [(int(r["step"]), k, np.float32(float(v))) for r in csv_rows for k, v in r.items()
            if k not in ("step", "epoch") and v not in ("", None) and k != "note"]
    assert [(s, t, np.float32(v)) for s, t, v in events] == want
    assert [r["step"] for r in jsonl_rows] == [1, 2, 3]


def _fake_services(calls):
    """Fake ``wandb``, ``mlflow``, ``comet_ml`` and ``neptune`` modules that
    append every call (name, arguments) to ``calls``."""
    def rec(name):
        return lambda *a, **k: calls.append((name, a, k))

    class Run:
        def __init__(self, kind):
            self.kind = kind

        def log(self, *a, **k):
            calls.append((f"{self.kind}.log", a, k))

        def finish(self):
            calls.append((f"{self.kind}.finish", (), {}))

        def stop(self):
            calls.append((f"{self.kind}.stop", (), {}))

        def __getitem__(self, key):
            return types.SimpleNamespace(append=lambda *a, **k: calls.append((f"{self.kind}[{key}].append", a, k)))

    class Experiment(Run):
        def __init__(self, **kw):
            super().__init__("comet")
            calls.append(("comet_ml.Experiment", (), kw))

        def log_metrics(self, *a, **k):
            calls.append(("comet.log_metrics", a, k))

        def end(self):
            calls.append(("comet.end", (), {}))

    def wandb_init(**kw):
        calls.append(("wandb.init", (), kw))
        return Run("wandb")

    def neptune_init(**kw):
        calls.append(("neptune.init_run", (), kw))
        return Run("neptune")

    mlflow = types.SimpleNamespace(**{n: rec(f"mlflow.{n}") for n in
                                      ("set_tracking_uri", "set_experiment", "start_run", "log_metrics", "end_run")})
    return {"wandb": types.SimpleNamespace(init=wandb_init), "mlflow": mlflow,
            "comet_ml": types.SimpleNamespace(Experiment=Experiment),
            "neptune": types.SimpleNamespace(init_run=neptune_init)}


SERVICES = {"wandb": {"project": "p", "name": "n"}, "mlflow": {"experiment_name": "e", "tracking_uri": "file:x"},
            "comet": {"project_name": "c"}, "neptune": {"project": "ws/p"}}


def test_service_backends_make_jax_calls(tmp_path, monkeypatch):
    """Each service backend, built from its config group, makes the JAX
    package's calls for the same metrics (a one-element tensor goes in as the
    float the JAX package's arrays give)."""
    logs = {}
    for name, mod in (("jax", jax_logging), ("port", port_logging)):
        calls = []
        for modname, fake in _fake_services(calls).items():
            monkeypatch.setitem(sys.modules, modname, fake)
        loggers = mod.build_loggers(SERVICES, str(tmp_path / name))
        assert [type(lg).__name__ for lg in loggers.loggers[1:]] == ["WandbLogger", "MLflowLogger", "CometLogger",
                                                                     "NeptuneLogger"]
        _log_all(loggers)
        loggers.finish()
        logs[name] = calls
    assert logs["port"] == logs["jax"] and len(logs["port"]) > 20
    calls = []
    for modname, fake in _fake_services(calls).items():
        monkeypatch.setitem(sys.modules, modname, fake)
    port_logging.build_loggers({"wandb": {}}, str(tmp_path / "t")).log({"train/loss": torch.tensor(1.5)}, step=4)
    assert calls[-1] == ("wandb.log", ({"train/loss": 1.5},), {"step": 4})


def test_missing_package_disables_backend(tmp_path, monkeypatch):
    """A backend whose package does not import is disabled in both packages
    (logging and finishing do nothing); the port warns once, naming it."""
    for modname in ("wandb", "mlflow", "comet_ml", "neptune", "tensorboardX", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, modname, None)
    warnings = []
    monkeypatch.setattr(port_logging.log, "warning", lambda msg, *a: warnings.append(msg % a))
    cfg = dict(SERVICES, tensorboard={})
    for name, mod in (("jax", jax_logging), ("port", port_logging)):
        loggers = mod.build_loggers(cfg, str(tmp_path / name))
        for lg in loggers.loggers[1:]:
            (handle,) = [getattr(lg, a) for a in ("run", "mlflow", "exp", "writer") if hasattr(lg, a)]
            assert handle is None, type(lg).__name__
        _log_all(loggers)
        loggers.finish()
        assert not os.path.exists(tmp_path / name / "tensorboard") or not os.listdir(tmp_path / name / "tensorboard")
    assert sorted(w.split()[2] for w in warnings) == sorted(["wandb", "mlflow", "comet", "neptune", "tensorboard"])
    assert all("disabled" in w for w in warnings)


CONFIG = {"task_name": "train", "tags": ["dev"], "model": {"lr": 1e-4, "layers": [1, 2]},
          "datamodule": {"dataloader_cfg": {"dataset": "QM9", "batch_size": 64}}, "seed": 42}


@pytest.mark.parametrize("rich", [True, False], ids=["rich", "plain"])
def test_print_config_tree_equals_jax(rich, monkeypatch, capsys):
    if not rich:
        for modname in ("rich", "rich.console", "rich.tree"):
            monkeypatch.setitem(sys.modules, modname, None)
    port_text = port_logging.print_config_tree(CONFIG)
    jax_text = jax_logging.print_config_tree(CONFIG)
    assert port_text == jax_text and "batch_size" in port_text
    assert capsys.readouterr().err == port_text + "\n" + jax_text + "\n"


@pytest.mark.parametrize("tags,strict,raises", [
    (["real-run"], True, False), ([], True, True), (["dev"], True, True), (None, False, False), (["dev"], False, False),
])
def test_enforce_tags_equals_jax(tags, strict, raises):
    cfg = {} if tags is None else {"tags": tags}
    for mod in (jax_logging, port_logging):
        if raises:
            with pytest.raises(ValueError, match="no experiment tags"):
                mod.enforce_tags(cfg, strict=strict)
        else:
            mod.enforce_tags(cfg, strict=strict)


def _jax_to_reference_name(key):
    """A JAX params path ``params/dynamics/...`` -> its reference state_dict name."""
    from bio_diffusion_torch.train.torch_import import state_dict_from_jax_params

    parts = key.split("/")
    tree = leaf = {}
    for p in parts[:-1]:
        leaf[p] = {}
        leaf = leaf[p]
    leaf[parts[-1]] = np.zeros((1, 1))
    (name,) = state_dict_from_jax_params(tree)
    return name


def test_grad_flow_summary_equals_jax():
    """Mean |grad| of every weight, biases skipped: the port's over reference
    names against the JAX package's over its params paths, the gradients
    mapped between the two layouts, within 1e-6 relative."""
    import jax
    import jax.numpy as jnp

    from bio_diffusion_torch.train.torch_import import state_dict_from_jax_params
    from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics
    from test_torch_common import jax_tiny_configs, tiny_batch

    net = JaxDynamics(*jax_tiny_configs(), remat_interactions=False)
    xh, t, mask = tiny_batch()
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.asarray(xh), jnp.asarray(t), jnp.asarray(mask))
    rng = np.random.default_rng(0)
    grads = {"params": {"dynamics": jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                                                 shapes["params"])}}
    want = {_jax_to_reference_name(k): v for k, v in jax_logging.grad_flow_summary(grads).items()}
    port_grads = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state_dict_from_jax_params(grads).items()}
    got = port_logging.grad_flow_summary(port_grads)
    assert sorted(got) == sorted(want) and len(got) > 20 and not any("bias" in k for k in got)
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


# ---------------------------------------------------------------------------
# hyperparameter study
# ---------------------------------------------------------------------------

SPACE = {"lr": "interval(1e-5, 1e-2, log)", "bs": "choice(32, 64, 128)", "layers": "int_interval(2, 9)",
         "x": "interval(0, 10)"}


def _objective(p):
    return (p["x"] - 3.0) ** 2 + abs(np.log10(p["lr"]) + 3) + 0.01 * p["layers"] + (p["bs"] == 64)


@pytest.mark.parametrize("sampler", ["random", "tpe"])
def test_study_suggests_what_jax_suggests(sampler):
    """The same seed and recorded values give the same suggestions (TPE
    after 4 random start-up trials)."""
    studies = [mod.Study(SPACE, sampler=sampler, n_startup_trials=4, seed=7) for mod in (jax_hparam, port_hparam)]
    for study in studies:
        for _ in range(12):
            p = study.suggest()
            study.record(p, _objective(p))
    assert studies[1].trials == studies[0].trials
    assert studies[1].best_trial() == studies[0].best_trial()
    for spec in ("interval(1e-5, 1e-2, log)", "choice(32, 64, 'a')", "int_interval(2, 9)", [0.1, "adam"], 3):
        assert vars(port_hparam.parse_dimension(spec)) == vars(jax_hparam.parse_dimension(spec))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_study_json_resumes_across_packages(first, tmp_path):
    """A study.json written by one package is resumed by the other, which
    suggests what the writer would have suggested next."""
    mods = {"jax": jax_hparam, "port": port_hparam}
    other = "port" if first == "jax" else "jax"
    path = str(tmp_path / "study.json")
    writer = mods[first].Study(SPACE, sampler="tpe", n_startup_trials=3, path=path)
    for _ in range(5):
        p = writer.suggest()
        writer.record(p, _objective(p))
    resumed = mods[other].Study(SPACE, sampler="tpe", n_startup_trials=3, path=path)
    assert resumed.trials == writer.trials
    assert resumed.suggest() == writer.suggest()
    with open(path) as f:
        assert set(json.load(f)) == {"space", "direction", "sampler", "trials"}


def test_read_metric_from_csv_equals_jax(tmp_path):
    path = str(tmp_path / "metrics.csv")
    with open(path, "w") as f:
        f.write("step,epoch,val/loss\n1,0,5.0\n2,1,3.0\n3,2,4.0\n4,2,\n")
    for reduce in ("last", "min", "max"):
        assert port_hparam.read_metric_from_csv(path, "val/loss", reduce) == \
            jax_hparam.read_metric_from_csv(path, "val/loss", reduce)
    for mod in (jax_hparam, port_hparam):
        with pytest.raises(KeyError):
            mod.read_metric_from_csv(path, "nope")


# ---------------------------------------------------------------------------
# grid search and k8s
# ---------------------------------------------------------------------------

GRID = {"model.optimizer.lr": [1e-4, 4e-4], "model.model_cfg.num_encoder_layers": [4, 9],
        "model.diffusion_cfg.num_timesteps": [1000]}


def _grids(tmp_path, monkeypatch):
    from bio_diffusion_torch.cli import generate_grid_search_runs

    space = tmp_path / "space.json"
    space.write_text(json.dumps(GRID))
    jax_gen = _script("generate_grid_search_runs")
    monkeypatch.setattr(sys, "argv", ["x", str(space), str(tmp_path / "jax")])
    jax_gen.main()
    generate_grid_search_runs.main([str(space), str(tmp_path / "port")])
    return [json.loads((tmp_path / n / "grid_manifest.json").read_text()) for n in ("jax", "port")]


def test_grid_manifest_equals_jax_apart_from_the_entry(tmp_path, monkeypatch, capsys):
    jax_m, port_m = _grids(tmp_path, monkeypatch)
    assert len(port_m) == 4
    for j, p in zip(jax_m, port_m):
        assert p["run_id"] == j["run_id"] and p["overrides"] == j["overrides"]
        assert p["cmd"].startswith("python -m bio_diffusion_torch.cli.train ")
        assert p["cmd"] == j["cmd"].replace("bio_diffusion_tpu", "bio_diffusion_torch").replace(
            str(tmp_path / "jax"), str(tmp_path / "port"))
    assert (tmp_path / "port" / "launch_all.sh").read_text().splitlines()[2:] == [m["cmd"] for m in port_m]
    # the monitor: one run done
    from bio_diffusion_torch.cli import monitor_grid_search

    for n in ("jax", "port"):
        (tmp_path / n / "run_0001.done").write_text("`on_fit_end` has been called.")
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["x", str(tmp_path / "jax")])
    _script("monitor_grid_search").main()
    jax_out = capsys.readouterr().out
    pending = monitor_grid_search.main([str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    assert [m["run_id"] for m in pending] == ["run_0000", "run_0002", "run_0003"]
    assert port_out == jax_out.replace("bio_diffusion_tpu", "bio_diffusion_torch").replace(
        str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("hosts", [1, 2])
def test_k8s_gpu_jobs(hosts, tmp_path, monkeypatch):
    """GPU Jobs from the grid manifest: YAML that parses, nvidia.com/gpu
    limits and requests, torchrun with one process a card, a node selector
    for --gpu-product, a headless Service per Job on more than one host (the
    JAX package's file layout, TPU Jobs there)."""
    from bio_diffusion_torch.cli import generate_k8s_jobs

    _grids(tmp_path, monkeypatch)
    out = tmp_path / "k8s"
    extra = ["--gpu-product", "NVIDIA-H100-80GB-HBM3"] if hosts > 1 else []
    paths = generate_k8s_jobs.main(["--manifest", str(tmp_path / "port" / "grid_manifest.json"), "--out-dir", str(out),
                                    "--num-hosts", str(hosts), "--gpus-per-host", "4", *extra])
    jax_paths = _script("generate_k8s_jobs").main(["--manifest", str(tmp_path / "jax" / "grid_manifest.json"),
                                                    "--out-dir", str(tmp_path / "k8s_jax"), "--num-hosts", str(hosts)])
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jax_paths]
    assert len(paths) == 1 + 4 * (2 if hosts > 1 else 1)
    job = yaml.safe_load((out / "job_run_0002.yaml").read_text())
    spec = job["spec"]
    assert job["kind"] == "Job" and spec["completions"] == hosts and spec["completionMode"] == "Indexed"
    pod = spec["template"]["spec"]
    ctr = pod["containers"][0]
    for kind in ("limits", "requests"):
        assert ctr["resources"][kind]["nvidia.com/gpu"] == 4 and "google.com/tpu" not in ctr["resources"][kind]
    cmd = ctr["command"][-1]
    master = f"{job['metadata']['name']}-0.{job['metadata']['name']}" if hosts > 1 else "localhost"
    assert cmd.startswith(f"torchrun --nnodes={hosts} --nproc-per-node=4 --node-rank=${{NODE_RANK}} "
                          f"--master-addr={master} --master-port=29500 -m bio_diffusion_torch.cli.train ")
    assert "task_name=run_0002" in cmd and "trainer.multihost" not in cmd
    assert ctr["env"][0]["name"] == "NODE_RANK"
    assert pod["nodeSelector"] == ({"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"} if hosts > 1 else {})
    if hosts > 1:
        svc = yaml.safe_load((out / "service_run_0002.yaml").read_text())
        assert svc["spec"]["clusterIP"] == "None" and svc["spec"]["ports"][0]["port"] == 29500
        assert svc["metadata"]["name"] == job["metadata"]["name"] == pod["subdomain"]
    assert yaml.safe_load((out / "persistent_storage.yaml").read_text())["kind"] == "PersistentVolumeClaim"
    assert (out / "apply_all.sh").read_text().count("kubectl apply") == len(paths)


def test_k8s_refuses_tpu_flags_and_unsubstituted_variables(tmp_path):
    from bio_diffusion_torch.cli import generate_k8s_jobs

    with pytest.raises(ValueError, match="unsubstituted"):
        generate_k8s_jobs.render("image: $NOT_A_VAR", {})
    with pytest.raises(SystemExit, match="TPU flag"):
        generate_k8s_jobs.main(["--experiment", "qm9_mol_gen_ddpm", "--out-dir", str(tmp_path), "--topology", "2x2"])
    paths = generate_k8s_jobs.main(["--experiment", "qm9_mol_gen_ddpm", "--out-dir", str(tmp_path / "one")])
    ctr = yaml.safe_load(open(paths[1]))["spec"]["template"]["spec"]["containers"][0]
    assert ctr["resources"]["limits"]["nvidia.com/gpu"] == 8
    assert "-m bio_diffusion_torch.cli.train experiment=qm9_mol_gen_ddpm" in ctr["command"][-1]


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


def _bust_csv(path, rate, n=20):
    from bio_diffusion_torch.analysis.inference_analysis import POSEBUSTERS_COLUMNS

    import pandas as pd

    rows = {c: [True] * n for c in POSEBUSTERS_COLUMNS[:4]}
    k = int(rate * n)
    rows[POSEBUSTERS_COLUMNS[0]] = [True] * k + [False] * (n - k)
    rows[POSEBUSTERS_COLUMNS[2]] = [True, False] * (n // 2)
    pd.DataFrame(rows).to_csv(path, index=False)


def test_inference_and_comparison_analysis_equal_jax(tmp_path, capsys):
    from bio_diffusion_torch.analysis import comparison_analysis as port_cmp
    from bio_diffusion_torch.analysis import inference_analysis as port_inf
    from bio_diffusion_tpu.analysis import comparison_analysis as jax_cmp
    from bio_diffusion_tpu.analysis import inference_analysis as jax_inf

    rng = np.random.default_rng(0)
    for i in range(4):
        (tmp_path / f"run{i}_eval_results.json").write_text(json.dumps(
            {"mol_stable": float(rng.random()), "atm_stable": float(rng.random()), "n": i, "tag": "x"}))
    files = sorted(str(p) for p in tmp_path.glob("*_eval_results.json"))
    assert port_inf.aggregate_eval_results(files) == jax_inf.aggregate_eval_results(files)
    for data in ([1.0], [0.2, 0.4, 0.9], list(rng.random(7))):
        assert port_inf.calculate_mean_and_conf_int(data, 0.9) == jax_inf.calculate_mean_and_conf_int(data, 0.9)
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    _bust_csv(a, 0.9)
    _bust_csv(b, 0.5)
    assert port_inf.posebusters_validity(a) == jax_inf.posebusters_validity(a)
    capsys.readouterr()
    port_inf.main([str(tmp_path / "*_eval_results.json"), a])
    port_out = capsys.readouterr().out
    jax_inf.main([str(tmp_path / "*_eval_results.json"), a])
    assert port_out == capsys.readouterr().out and "pb_valid" in port_out

    import matplotlib.image as mpimg

    pngs = {}
    for name, mod in (("jax", jax_cmp), ("port", port_cmp)):
        got = mod.compare_bust_csvs(a, b, labels=("gcdm", "geoldm"), out_png=str(tmp_path / f"{name}_cmp.png"))
        pngs[name] = got
    assert pngs["port"] == pngs["jax"]
    hist = []
    for prop, stab, mae in [("alpha", 0.9, 2.5), ("gap", 0.85, 1.1)]:
        p = tmp_path / f"{prop}.json"
        p.write_text(json.dumps({"property": prop, "final": {"mol_stable": stab, "mae": mae}}))
        hist.append(str(p))
    for name, mod in (("jax", jax_cmp), ("port", port_cmp)):
        mod.plot_optimization_history(hist, str(tmp_path / f"{name}_opt.png"))
    for kind in ("cmp", "opt"):
        assert np.array_equal(mpimg.imread(tmp_path / f"port_{kind}.png"), mpimg.imread(tmp_path / f"jax_{kind}.png"))
    assert port_cmp.PAPER_OPT_100_STEPS == jax_cmp.PAPER_OPT_100_STEPS


def test_molecule_and_qm_analysis_equal_jax(tmp_path, monkeypatch):
    """obabel, PoseBusters, psi4 and crest are not installed: both packages
    degrade alike; with obabel, crest (through ``shutil.which`` and
    ``subprocess.run``) and psi4 (a fake module) faked, both give the same
    files and values."""
    from bio_diffusion_torch.analysis import molecule_analysis as port_mol
    from bio_diffusion_torch.analysis import qm_analysis as port_qm
    from bio_diffusion_tpu.analysis import molecule_analysis as jax_mol
    from bio_diffusion_tpu.analysis import qm_analysis as jax_qm

    xyz_dir = tmp_path / "xyz"
    xyz_dir.mkdir()
    for name in ("b.xyz", "a.xyz"):
        (xyz_dir / name).write_text("2\ncomment\nC 0.0 0.0 0.0\nO 1.2 0.0 0.0\n")
    monkeypatch.setitem(sys.modules, "posebusters", None)
    monkeypatch.setitem(sys.modules, "psi4", None)
    for mol, qm in ((jax_mol, jax_qm), (port_mol, port_qm)):
        monkeypatch.setattr(mol.shutil, "which", lambda name: None)
        assert mol.xyz_to_sdf_obabel(str(xyz_dir / "a.xyz"), str(tmp_path / "a.sdf")) is False
        assert mol.convert_xyz_dir_to_sdf(str(xyz_dir)) == []
        assert mol.bust_molecules([str(tmp_path / "a.sdf")], str(tmp_path / "bust.csv")) is None
        assert qm.compute_polarizability_psi4(str(xyz_dir / "a.xyz")) is None
        assert qm.compute_xtb_energy_crest(str(xyz_dir / "a.xyz")) is None

    runs = []

    def fake_run(cmd, capture_output=True, text=True):
        runs.append(list(cmd))
        if cmd[0] == "obabel":
            open(cmd[-1], "w").write("sdf\n")
            return subprocess.CompletedProcess(cmd, 0, "", "")
        return subprocess.CompletedProcess(cmd, 0, "header\n   total energy   -12.3456 Eh\n", "")

    psi4 = types.SimpleNamespace(geometry=lambda g: g, set_options=lambda o: None,
                                 properties=lambda *a, **k: None,
                                 core=types.SimpleNamespace(variable=lambda name: 42.5))
    monkeypatch.setitem(sys.modules, "psi4", psi4)
    out = {}
    for name, mol, qm in (("jax", jax_mol, jax_qm), ("port", port_mol, port_qm)):
        monkeypatch.setattr(mol.shutil, "which", lambda tool: tool)
        monkeypatch.setattr(mol.subprocess, "run", fake_run)
        sdfs = [os.path.basename(p) for p in mol.convert_xyz_dir_to_sdf(str(xyz_dir))]
        out[name] = (sdfs, qm.recompute_directory(str(xyz_dir), "psi4"), qm.recompute_directory(str(xyz_dir), "xtb"))
    assert out["port"] == out["jax"] == (["a.sdf", "b.sdf"], [42.5, 42.5], [-12.3456, -12.3456])
    assert runs[: len(runs) // 2] == runs[len(runs) // 2:]
