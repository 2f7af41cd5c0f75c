"""The smoke's phase timer: cutting a stamped output at each phase's end, and
running a checkout's smoke with its lines stamped."""

import json
import sys

import pytest

from bio_diffusion_torch.cli import smoke_phases


def _stamped(ends):
    """A stamped output whose i-th phase ends at second 10 * (i + 1), with a
    line of other text before each end."""
    lines = []
    for i, end in enumerate(ends):
        lines.append(f"{10.0 * i + 5:9.3f} some line\n")
        lines.append(f"{10.0 * (i + 1):9.3f} {end} 1.000 s\n")
    return lines + [f"{10.0 * len(ends) + 1:9.3f} [exit 0]\n"]


def test_phase_seconds_cuts_at_each_end():
    ends = [end for _, end in smoke_phases.PHASES]
    got = smoke_phases.phase_seconds(_stamped(ends))
    assert list(got) == [name for name, _ in smoke_phases.PHASES] + ["total"]
    assert all(got[name] == pytest.approx(10.0) for name, _ in smoke_phases.PHASES)
    assert got["total"] == pytest.approx(10.0 * len(ends) + 1)


def test_phase_seconds_merges_a_phase_whose_end_is_missing():
    # an older smoke without the pass probe's end: its time goes to the next phase
    (n1, _), (n2, e2) = smoke_phases.PHASES[-2:]
    ends = [end for _, end in smoke_phases.PHASES[:-2]] + [e2]
    got = smoke_phases.phase_seconds(_stamped(ends))
    assert n1 not in got and got[f"{n1} + {n2}"] == pytest.approx(10.0)


def test_phase_seconds_takes_an_end_only_after_the_previous_one():
    # "reverse step " also starts lines before the server's requests end
    lines = [" 1.000 built kernels\n", " 2.000 reverse step early\n", " 3.000 unfused path: 1\n"]
    got = smoke_phases.phase_seconds(lines)
    assert got["B1, B2, B3 against plain; unfused path"] == pytest.approx(2.0)
    assert "reverse step" not in " ".join(got)


def test_run_stamps_a_checkout_smoke(tmp_path, capsys):
    checkout = tmp_path / "checkout"
    (checkout / "outputs").mkdir(parents=True)
    (checkout / "outputs" / "stale").write_text("x")
    (checkout / "chip_smoke.py").write_text("import os\nprint('built kernels')\n"
                                             "print('outputs left', os.path.exists('outputs'))\n"
                                             "raise SystemExit(3)\n")
    out = tmp_path / "smoke.txt"
    assert smoke_phases.run(str(checkout), str(out)) == 3
    lines = out.read_text().splitlines()
    assert [l.split(None, 1)[1] for l in lines] == ["built kernels", "outputs left False", "[exit 3]"]
    assert smoke_phases.compare([str(out)])[str(out)]["start and kernel build"] >= 0.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[str(out)]["total"] >= 0.0


def test_main_refuses_unknown_arguments():
    assert smoke_phases.main(["walk"]) == 2
    assert smoke_phases.main(["--help"]) == 0


def test_tools_phase_follows_the_module_path_denoisers():
    """The "tools" phase runs after "module-path denoisers" and ends on its
    own line, which cuts its seconds out of a stamped output."""
    names = [name for name, _ in smoke_phases.PHASES]
    assert names.index("tools") == names.index("module-path denoisers") + 1
    ends = [end for _, end in smoke_phases.PHASES]
    assert dict(smoke_phases.PHASES)["tools"] == "tools phase"
    lines = _stamped(ends)
    assert "tools phase 1.000 s\n" in [l.split(None, 1)[1] for l in lines]
    assert smoke_phases.phase_seconds(lines)["tools"] == pytest.approx(10.0)


def test_model_axis_phase_follows_data_parallel():
    """The "model axis" phase runs after "data parallel" (whose one-process
    run it reuses) and ends on its own line; its rank lines ("model axis
    (a) ...") do not end it."""
    names = [name for name, _ in smoke_phases.PHASES]
    assert names.index("model axis") == names.index("data parallel") + 1
    ends = [end for _, end in smoke_phases.PHASES]
    lines = _stamped(ends)
    at = lines.index(f"{10.0 * (names.index('model axis') + 1):9.3f} model axis phase 1.000 s\n")
    lines.insert(at, f"{10.0 * names.index('model axis') + 6:9.3f} model axis (a) rank 0: 27 launches\n")
    assert smoke_phases.phase_seconds(lines)["model axis"] == pytest.approx(10.0)
