"""The plain reference against the port's plain CPU path at toy widths:
serving (`CSModel.reconstruct`), the train path's augmentation and crop,
and three Mixed steps; and the benchmark's weights loading into both.
The test imports both; the reference imports nothing of the port."""

import numpy as np
import pytest
import torch

from harness import program
from harness.cell import Run
from harness.registry import Registry
from reference.ops import center_crop, pbspline
from toy import toy_cell

SEED = 2 ** 33 + 12345  # more than 32 bits, as the driver's seeds are


def _loop(name, config=None, seed=SEED):
    run = Run(toy_cell(name, config), seed, "cpu")
    return Registry().loop(run.traffic["loop"])(run)


@pytest.mark.parametrize("config", ["san_f32", "san_bf16"])
def test_serving_matches_the_reference(config):
    loop = _loop("serve_f32_b8", config)
    loop.setup()
    loop.window(0.2)
    loop.free()
    err = loop.check()["rec_rel_l2"]
    # f32: the same math in another order; bf16: the policy's own rounding
    assert err < (1e-5 if config == "san_f32" else 5e-2)
    assert len(loop.kept) >= 1


def test_augmentation_and_crop_match_the_reference():
    gen = torch.Generator().manual_seed(3)
    full = torch.complex(torch.randn(4, 1, 36, 36, generator=gen), torch.randn(4, 1, 36, 36, generator=gen))
    aux = torch.complex(torch.randn(4, 1, 36, 36, generator=gen), torch.randn(4, 1, 36, 36, generator=gen))
    draws = program.draw_pbspline(torch.Generator().manual_seed(4), 4, "cpu")
    got = program.augment_and_crop(full, aux, draws, 32)
    want = [center_crop(x, 32) for x in pbspline([full, aux], draws)]
    for g, w in zip(got, want):
        assert g.shape == (4, 1, 32, 32)
        # the two grids (the port's affine products, F.affine_grid's
        # matmul) differ in the last bit, read on images of unit slope
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_three_mixed_steps_match_the_reference():
    loop = _loop("train_mixed_f32_b4")
    loop.setup()
    loop.free()
    got = loop.check()
    assert got["loss_rel_first"] < 1e-5
    assert got["loss_rel"] < 1e-3
    assert got["grad_norm_gap"] < 5e-3
    assert got["stats_gap"] < 5e-3
    assert got["change_gap_median"] < 1e-2
    assert len(loop.record["losses"]) == 3 and all(np.isfinite(loop.record["losses"]))


def test_the_weights_load_into_the_port_and_the_reference():
    from harness import weights
    from reference.model import Reference

    cfg = toy_cell("serve_f32_b8")["config"]["model"]
    state = weights.draw(cfg, SEED, "cpu")
    model = program.build_model(cfg, state, 7, "cpu")
    ref = Reference(cfg, state, 7, "cpu")
    for name in ("net_T", "net_R", "net_G", "net_D"):
        a, b = getattr(model, name).state_dict(), ref.nets[name].state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    assert np.array_equal(model.pruned.numpy(), ref.pruned.numpy())
    again = weights.draw(cfg, SEED, "cpu")
    assert all(torch.equal(state[n][k], again[n][k]) for n in state for k in state[n])
