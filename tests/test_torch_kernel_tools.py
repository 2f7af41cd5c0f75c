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
    for num_gcps in (1, 3):
        names = kernel_phases.phase_names(num_gcps)
        assert len(names) == len(set(names)) == kernel.count("PHASE_MARK();") + num_gcps * stage.count("PHASE_MARK();")
        assert len(names) <= kernel_phases.SLOTS
    # without PHASE_PROBE the marks are empty statements
    assert "#define PHASE_MARK() do {} while (0)" in common
    assert f"constexpr int PHASE_SLOTS = {kernel_phases.SLOTS};" in common
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
        assert len(names) <= kernel_phases.SLOTS
    probe = source[source.index("#ifdef PHASE_PROBE"):]
    assert "phases_read" in probe and "phases_reset" in probe


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
