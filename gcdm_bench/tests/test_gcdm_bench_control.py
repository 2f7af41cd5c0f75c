"""On the card: the control (the plain reference in TF32 put in the
program's place) fails a cell's limits where the program passes them, at
the published widths and small batches."""

import pytest
import torch

from gcdm_bench.tests.tiny import execute, tiny_root

SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"), published_widths=True)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["qm9_sample_b250", "qm9_train_b64", "geom_train_b64"])
def test_the_control_fails_where_the_program_passes(root, workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels and TF32 exist only on the card")
    res = execute(root, workload, seed=seed, device="cuda", control=True)
    assert res["correct"], res["checks"]
    failed = [k for k, c in res["checks"].items() if res["controls"][f"control.{k}"] > c["limit"]]
    assert failed, (res["checks"], res["controls"])
