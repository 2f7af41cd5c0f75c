"""The frozen FLOP formula against ``FlopCounterMode`` over the plain reference."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gcdm_bench import program, yardstick
from gcdm_bench.harness import ROOT


def config(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["qm9_mol_gen_ddpm", "geom_mol_gen_ddpm"])
@pytest.mark.parametrize("n", [3, 5])
def test_denoiser_flops_match_the_counter(name, n):
    cfg = config(name)
    net = program.reference_dynamics(cfg, "cpu")
    b, f = 2, program.num_features(cfg)
    xh, t, mask = torch.randn(b, n, f), torch.rand(b, 1), torch.ones(b, n)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(xh, t, mask)
    assert counter.get_total_flops() == yardstick.denoiser_flops(cfg, [n] * b)


@pytest.mark.parametrize("name", ["qm9_mol_gen_ddpm", "geom_mol_gen_ddpm"])
def test_message_layer_flops_match_the_counter(name):
    cfg = config(name)
    w = yardstick.widths(cfg)
    layer = program.reference_dynamics(cfg, "cpu").interaction_layers[0].interaction
    b, n = 2, 4
    s, v = torch.randn(b, n, w["S"]), torch.randn(b, n, 3, w["V"])
    e, xi = torch.randn(b, n, n, w["Se"]), torch.randn(b, n, n, 3, w["Ve"])
    frames = torch.randn(b, n, n, 3, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        layer(s, v, e, xi, frames, torch.ones(b, n, n))
    assert counter.get_total_flops() == yardstick.message_layer_flops(cfg, [n] * b)


def test_message_layer_weights_count_the_stack():
    cfg = config("qm9_mol_gen_ddpm")
    layer = program.reference_dynamics(cfg, "cpu").interaction_layers[0].interaction
    assert sum(p.numel() for p in layer.parameters()) == yardstick.message_layer_weights(cfg)


def test_peaks_have_the_h100():
    row = yardstick.peaks("NVIDIA H100 80GB HBM3")
    assert row["flops"]["fp32"] == 67e12 and row["hbm_bytes_per_s"] == 3.35e12
    assert yardstick.peaks("some other card") is None
