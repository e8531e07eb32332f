"""benchmark/cost counts the stages as chip_smoke.py does, for every
stage of both configurations."""

import pytest
import torch

from benchmark.cost import stages
from benchmark.harness import registry


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("config", ["dragon_specular", "dragon_sss"])
@pytest.mark.parametrize("path", ["train", "serve"])
def test_stage_cost_equals_chip_smoke(smoke, config, path):
    cfg = registry.config(config)
    launches = stages.fused_launches(cfg, cfg["bs"], path)
    assert launches
    for op, shape, dtype, o in launches:
        x = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
        assert stages.stage_cost(op, shape, stages.ITEMSIZE[dtype], o) == \
            smoke.stage_cost(op, x, o)


def test_sss_stages_are_chip_smokes_recipe_stages(smoke):
    cfg = registry.config("dragon_sss")
    bs, dtype, want = smoke.RECIPE_STAGES["dragon_sss.ini"]
    got = stages.fused_launches(cfg, bs, "train")
    contract = [(op, s[3], o, s[1]) for op, s, _, o in got
                if op == "contract_stage"]
    expand = [(op, s[3], o, s[1]) for op, s, _, o in got
              if op == "expand_stage"]
    assert contract + expand == want
    assert {d for _, _, d, _ in got} == {dtype}


def test_specular_stages_are_the_flagship_stages(smoke):
    cfg = registry.config("dragon_specular")
    got = stages.fused_launches(cfg, 4, "train")
    assert sorted((op, s[3], o, s[1]) for op, s, _, o in got) == \
        sorted(smoke.FLAGSHIP_STAGES)
    assert len(stages.fused_launches(cfg, 1, "serve")) == 12


def test_unet_flops_count_every_conv():
    cfg = registry.config("dragon_specular")
    q = stages.unet_flops(cfg, ("query",))
    both = stages.unet_flops(cfg)
    assert 0 < q < both
    fused = sum(stages.stage_cost(op, s, 4, o)[1]
                for op, s, _, o in stages.fused_launches(cfg, 1, "serve"))
    # the 1x1 in and out convs are the rest
    assert q - fused == 2 * 512 * 512 * (5 * 16 + 36 * 3)
