"""The harness end to end on the CPU at a tiny width: a sound run is
correct, each fault the cells can have makes it not correct, and a new
traffic file, driver and metric file named in a manifest are found and run
without an edit to any file that is there."""

import json

import pytest

from gcdm_bench import harness
from gcdm_bench.tests.tiny import execute, tiny_root

WORKLOADS = ["qm9_sample_b250", "qm9_train_b64", "geom_train_b64"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(root, workload):
    res = execute(root, workload)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in harness.end_to_end(harness.load_manifest(), workload)}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res["checks"]) == list(json.loads((root / "limits" / f"{workload}.json").read_text()))


@pytest.mark.parametrize("workload,fault", [
    ("qm9_sample_b250", "answer"),  # an answer altered where it is produced
    ("qm9_sample_b250", "frozen"),  # a reverse step that returns its state unchanged
    ("qm9_train_b64", "frozen"),  # an optimizer step that leaves the state unchanged
    ("qm9_train_b64", "half_batch"),  # half the batch left out, the mean over the rest
    ("geom_train_b64", "frozen"),
    ("geom_train_b64", "half_batch"),
    # steps that leave the state unchanged only after set-up, inside the window
    ("qm9_train_b64", "frozen_in_window"),
    ("geom_train_b64", "frozen_in_window"),
])
def test_a_fault_in_the_timed_path_is_not_correct(root, workload, fault):
    assert not execute(root, workload, fault=fault)["correct"]


def manifest_with(root, tmp_path, workload, traffic, per_layer):
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": workload, "config": "qm9_mol_gen_ddpm", "traffic": traffic, "chips": 1,
                                  "why": "test"})
    manifest["per_layer"] += [
        {"name": name, "unit": "calls", "better": "higher", "source": "program_counter", "layer": "sampler",
         "moves": "sample_evals_per_s", "workloads": [workload]} for name in per_layer]
    manifest["end_to_end"][0]["workloads"].append(workload)
    path = tmp_path / "manifest.json"
    path.write_text(json.dumps(manifest))
    (root / "limits" / f"{workload}.json").write_text((root / "limits" / "qm9_sample_b250.json").read_text())
    return path


def test_a_new_traffic_driver_and_metric_file_are_found(root, tmp_path):
    spec = json.loads((root / "traffic" / "qm9_sample_b250.json").read_text())
    spec.update(kind="sample_noted", batch_size=3, batches=2)
    (root / "traffic" / "qm9_sample_small.json").write_text(json.dumps(spec))
    (root / "drivers" / "sample_noted.py").write_text(
        "from pathlib import Path\n"
        "from gcdm_bench import harness\n\n\n"
        "def drive(run):\n"
        "    harness.load('drivers', 'sample', Path(__file__).parent.parent).drive(run)\n"
        "    run.out['ctx']['noted'] = 1.0\n")
    (root / "metrics" / "denoiser_calls_seen.py").write_text(
        "def read(ctx):\n    return ctx.get('denoiser_calls')\n")
    (root / "metrics" / "noted.py").write_text("def read(ctx):\n    return ctx.get('noted')\n")
    path = manifest_with(root, tmp_path, "qm9_sample_small", "qm9_sample_small", ["denoiser_calls_seen", "noted"])
    res = execute(root, "qm9_sample_small", trace=1, manifest=path)
    assert res["correct"]
    assert res["metrics"]["noted"]["value"] == 1.0
    assert res["metrics"]["denoiser_calls_seen"]["value"] == 4  # a traced batch of 3 steps and the decode


def test_a_listed_metric_that_reads_nothing_is_an_error(root, tmp_path):
    (root / "metrics" / "silent.py").write_text("def read(ctx):\n    return None\n")
    path = manifest_with(root, tmp_path, "qm9_sample_silent", "qm9_sample_b250", ["silent"])
    with pytest.raises(SystemExit, match="silent"):
        execute(root, "qm9_sample_silent", trace=1, manifest=path)


def test_every_per_layer_metric_lists_its_cells():
    manifest = harness.load_manifest()
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
