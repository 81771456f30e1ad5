"""The benchmark's operation and byte counts at known shapes."""

import json

import pytest

from benchmark import counts, spec


@pytest.fixture(scope="module")
def tiny_model():
    with open(spec.HERE / "configs" / "convnext_tiny-bf16-serve.json") as f:
        return json.load(f)["model"]


def test_stage_shapes_of_a_10s_clip(tiny_model):
    assert counts.frames(tiny_model, 320000) == 1001
    assert counts.stage_shapes(tiny_model, 320000) == [
        (252, 56, 96), (126, 28, 192), (63, 14, 384), (31, 7, 768)]


def test_trunk_is_19_9_g_multiply_adds_a_clip(tiny_model):
    macs = counts.trunk_macs(tiny_model, 320000)
    g = {k: v / 1e9 for k, v in macs.items()}
    assert g["stage1"] == pytest.approx(3.32, abs=0.01)
    assert g["stage2"] == pytest.approx(3.22, abs=0.01)
    assert g["stage3"] == pytest.approx(9.51, abs=0.01)
    assert g["stage4"] == pytest.approx(3.10, abs=0.01)
    assert g["downsamples"] == pytest.approx(0.78, abs=0.01)
    assert sum(macs.values()) / 1e9 == pytest.approx(19.93, abs=0.02)
    # the frontend: 1001 FFTs of 1024 points and the 513 x 224 mel product
    assert counts.frontend_flops(tiny_model, 320000) == pytest.approx(
        1001 * 5 * 1024 * 10 + 2 * 1001 * 513 * 224)
    assert counts.model_flops(tiny_model, 320000) / 1e9 == pytest.approx(40.14, abs=0.05)


def test_k1_counts_at_a_stage_3_batch_of_16():
    flops, nbytes = counts.k1_counts((16, 63, 14, 384))
    px = 16 * 63 * 14
    assert flops == 2 * px * 384 * (49 + 8 * 384)
    assert nbytes == 2 * px * 384 * 2 + (49 * 384 + 8 * 384 * 384) * 2 + 8 * 384 * 4
    # compute-bound: the least time is the FLOPs at the bf16 peak
    assert counts.least_seconds(flops, nbytes) == pytest.approx(flops / 989e12)


def test_k2_counts_and_the_least_time():
    flops, nbytes = counts.k2_counts((64, 31, 7, 768))
    px = 64 * 31 * 7
    assert flops == 2 * px * (20 * 768 * 768 + 98 * 768)
    assert nbytes > 4 * px * 768 * 2
    assert counts.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_train_flops_counts_three_trunk_forwards(tiny_model):
    trunk = 2 * sum(counts.trunk_macs(tiny_model, 320000).values())
    fe = counts.frontend_flops(tiny_model, 320000)
    assert counts.train_flops(tiny_model, 320000, 64, 128) == pytest.approx(
        3 * trunk * 64 + fe * 128)
