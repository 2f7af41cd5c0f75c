"""The kernel measurement tools on the CPU.  The phase probe of the forward
kernel and of the backward's row kernel (``cli/kernel_phases.py``): the
kernels' sources carry one phase mark per block barrier, as many as the probe
names, and compile them to nothing unless built with ``PHASE_PROBE``.  The A/B timer (``cli/ab_kernels.py``):
``build.library_override`` routes an ops module's launches to another library
only inside its block.  Both refuse without a card.  Imports no jax."""

import types

import pytest
import torch

from bio_diffusion_torch.cli import ab_kernels, kernel_phases
from bio_diffusion_torch.ops import build, gcp2_chain, message_layer
from bio_diffusion_torch.ops.build import SOURCE_DIR


def test_instrumented_source_marks_every_named_phase():
    common = (SOURCE_DIR / "message_layer_common.cuh").read_text()
    source = (SOURCE_DIR / "message_layer.cu").read_text()
    stage = common[common.index("void chain_stage"):common.index("// Sigmoid scalar attention")]
    kernel = source[source.index("message_layer_kernel(const Params<T> p)"):source.index("int launch(")]
    # each barrier of the stage and of the kernel ends one phase; the kernel's
    # end ends the last
    for body in (stage, kernel):
        lines = [ln.strip() for ln in body.splitlines()]
        after = [lines[k + 1] for k, ln in enumerate(lines) if ln.startswith("__syncthreads();")]
        assert after and all(ln == "PHASE_MARK();" for ln in after)
    assert stage.count("PHASE_MARK();") == stage.count("__syncthreads();") == 5
    assert kernel.count("PHASE_MARK();") == kernel.count("__syncthreads();") + 1
    assert kernel.count("PHASE_START();") == 1
    # one count of computed and covered rows a block, in the slots past the marks
    assert kernel.count("PHASE_ROWS(") == 1
    for num_gcps in (1, 3):
        names = kernel_phases.phase_names(num_gcps)
        assert len(names) == len(set(names)) == kernel.count("PHASE_MARK();") + num_gcps * stage.count("PHASE_MARK();")
        assert len(names) <= kernel_phases.ROW_SLOTS[0]
    # without PHASE_PROBE the marks and the row counts are empty statements
    assert "#define PHASE_MARK() do {} while (0)" in common
    assert "#define PHASE_ROWS(computed, covered) do {} while (0)" in common
    assert f"constexpr int PHASE_SLOTS = {kernel_phases.SLOTS};" in common
    assert "constexpr int PHASE_MARKS = PHASE_SLOTS - 2;" in common
    assert kernel_phases.ROW_SLOTS == (kernel_phases.SLOTS - 2, kernel_phases.SLOTS - 1)
    assert f"constexpr int ROWS = {kernel_phases.ROWS};" in source
    assert f"constexpr int RPT = {kernel_phases.RPT};" in source
    assert "phases_read" in source[source.index("#ifdef PHASE_PROBE"):]


def _marks_follow_barriers(body):
    lines = [ln.strip() for ln in body.splitlines()]
    after = [lines[k + 1] for k, ln in enumerate(lines) if ln.startswith("__syncthreads();")]
    return bool(after) and all(ln == "PHASE_MARK();" for ln in after)


def test_bwd_row_kernel_marks_every_named_phase():
    source = (SOURCE_DIR / "message_layer_bwd.cu").read_text()
    kernel = source[source.index("bwd_rows_kernel(const BwdParams<T> p)"):source.index("// d_proj_i[b, i, c]")]
    assert _marks_follow_barriers(kernel)
    # one mark per barrier and one at the end of each tile; each tile starts
    # the counters' order again
    assert kernel.count("PHASE_MARK();") == kernel.count("__syncthreads();") + 1
    assert kernel.count("PHASE_START();") == kernel.count("PHASE_FOLD();") == 1
    # the stage loops' marks count once per chain stage
    fwd = kernel[kernel.index("for (int g = 0; g < d.G; ++g)"):kernel.index("// attention logit")]
    bwd = kernel[kernel.index("for (int g = d.G - 1; g >= 0; --g)"):kernel.index("// GCP1")]
    per_stage = fwd.count("PHASE_MARK();") + bwd.count("PHASE_MARK();")
    assert fwd.count("PHASE_MARK();") == bwd.count("PHASE_MARK();") == 5
    for num_gcps in (1, 3, 4):
        names = kernel_phases.phase_names(num_gcps, "bwd")
        assert len(names) == len(set(names)) == kernel.count("PHASE_MARK();") + (num_gcps - 1) * per_stage
        assert len(names) <= kernel_phases.ROW_SLOTS[0]
    probe = source[source.index("#ifdef PHASE_PROBE"):]
    assert "phases_read" in probe and "phases_reset" in probe


@pytest.mark.parametrize("sizes,pad,computed", [
    # a block of a real node of n atoms computes n rows rounded up to 8 (RPT),
    # in tiles of 32: 1 -> 8, 8 -> 8, 9 -> 16, 29 -> 32
    ([1, 8, 9, 29], 29, 1 * 8 + 8 * 8 + 9 * 16 + 29 * 32),
    # past one tile only the last is rounded: 33 -> 32 + 8, 64 -> 64, 70 -> 64 + 8
    ([33, 64, 70], 96, 33 * 40 + 64 * 64 + 70 * 72),
    # a molecule of no atom computes nothing; all padding covers its rows
    ([0, 5, 6], 6, 5 * 8 + 6 * 8),
    ([32, 32], 32, 2 * 32 * 32),
])
def test_expected_rows_match_a_hand_count(sizes, pad, computed):
    assert kernel_phases.expected_rows(sizes, pad) == (computed, len(sizes) * pad * pad)


def test_qm9_sizes_pad_as_the_sampler_pads():
    """``--qm9-sizes``: the sizes and padded size ``sample_molecules`` gives
    one batch of B molecules drawn from the QM9 histogram with the same
    seed (a sampler that records the node masks it is handed); at B=250
    about half the covered rows are computed."""
    import numpy as np

    from bio_diffusion_torch.data.dataset_info import QM9_WITH_H
    from bio_diffusion_torch.models.distributions import NumNodesDistribution
    from bio_diffusion_torch.train.sampling import sample_molecules

    class Recorder:
        masks = []

        def run(self, node_mask, generator, **kwargs):
            self.masks.append(node_mask)
            return np.zeros(node_mask.shape + (3,), np.float32)

    dist = NumNodesDistribution(QM9_WITH_H["n_nodes"])
    for seed in range(4):
        sizes, pad = kernel_phases.qm9_batch(250, seed)
        sample_molecules(Recorder(), None, 250, dist, np.random.default_rng(seed), batch_size=250)
        mask = Recorder.masks[-1]
        assert (pad, sorted(sizes.tolist())) == (mask.shape[1], sorted(mask.sum(1).astype(int).tolist()))
        assert kernel_phases.qm9_batch(250, seed)[0].tolist() == sizes.tolist()
        computed, covered = kernel_phases.expected_rows(sizes, pad)
        assert 0.45 < computed / covered < 0.6


def test_kernel_phases_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        kernel_phases.main(["--n", "19"])
    with pytest.raises(SystemExit, match="N <= 32"):
        kernel_phases.main(["--n", "40"])
    with pytest.raises(SystemExit, match="unknown argument"):
        kernel_phases.main(["--rows", "8"])
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        kernel_phases.main(["--kernel", "bwd", "--n", "40", "--precision", "fp32"])
    with pytest.raises(SystemExit, match="fwd or bwd"):
        kernel_phases.main(["--kernel", "chain"])
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        kernel_phases.main(["--qm9-sizes", "3", "--precision", "fp32"])
    with pytest.raises(SystemExit, match="give no --n"):
        kernel_phases.main(["--qm9-sizes", "3", "--n", "29"])


class _Library:
    """Stands in for another build's ctypes library: any C function."""

    def __getattr__(self, fn):
        f = types.SimpleNamespace(argtypes=None, restype=None)
        setattr(self, fn, f)
        return f


@pytest.mark.parametrize("module,name", [(message_layer, "message_layer"), (gcp2_chain, "gcp2_chain")])
def test_ab_kernels_routes_launches_only_inside_its_block(module, name):
    other = _Library()
    with build.library_override(name, other):
        assert build.load_library(name) is other
        fn = module._kernel_function(torch.bfloat16)
        assert fn is getattr(other, module._C_FUNCTIONS[torch.bfloat16]) and fn.argtypes
        with pytest.raises(RuntimeError, match="already overridden"):
            with build.library_override(name, _Library()):
                pass
    assert name not in build._overrides


def test_ab_kernels_routes_the_backward_only_inside_its_block():
    other = _Library()
    with build.library_override("message_layer_bwd", other):
        lib = message_layer._bwd_library()
        assert lib is other and lib.message_layer_bwd_workspace.argtypes
        assert all(getattr(other, fn).argtypes for fn in message_layer._C_BWD_FUNCTIONS.values())
    assert "message_layer_bwd" not in build._overrides
    assert "message_layer_bwd" in ab_kernels.NAMES


def test_ab_kernels_refuses_without_a_card_or_a_source():
    with pytest.raises(SystemExit, match="needs --other"):
        ab_kernels.main([])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        ab_kernels.main(["--other", "build/parent"])
