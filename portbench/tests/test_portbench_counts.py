"""The analytic counts of portbench/counts.py, pinned to their values,
and the frozen copies held to the port's own functions today."""

import json
from pathlib import Path

import pytest

from portbench import counts

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


@pytest.fixture(scope="module")
def ntm():
    return json.loads((CONFIGS / "ntm_offsets.json").read_text())


def test_frame_and_train_flops_pinned(ntm):
    assert counts.cell_step_flops(ntm) == 1_441_600
    assert counts.frame_flops(ntm) == 16_207_746_368  # 16.21 GFLOP a frame
    assert counts.train_step_flops(ntm, 256, 20) == 1_439_293_440_000  # 1.439 TFLOP


def test_vgg_flops_pinned():
    assert counts.vgg_flops() == 16_114_042_368


def test_kernel_counts_pinned(ntm):
    got = counts.b2_counts(ntm, 256, 20)
    assert got == (1_439_293_440_000, 702_489_056)
    _, bound = counts.least_seconds(*got, counts.PEAKS["H100 80GB HBM3"])
    assert bound == "compute"


def test_least_seconds_picks_the_larger_bound():
    card = {"float32": 1.0, "hbm_bytes_per_s": 1.0}
    assert counts.least_seconds(2.0, 1.0, card) == (2.0, "compute")
    assert counts.least_seconds(1.0, 3.0, card) == (3.0, "bytes")


def test_peaks_by_card_name():
    assert counts.peaks("NVIDIA H100 80GB HBM3")["float32"] == 67.0e12
    assert counts.peaks("NVIDIA H100 PCIe")["hbm_bytes_per_s"] == 2.0e12
    assert counts.peaks("cpu") is None


def test_frozen_copies_equal_the_port_today(ntm):
    """The copies agree with benchmarks.frame_flops and
    tools/profile_train's counts as the port has them."""
    from ntm_tracker_tpu_torch.benchmarks import frame_flops
    from ntm_tracker_tpu_torch.config import TrackerConfig, TrainConfig
    from ntm_tracker_tpu_torch.tools.profile_train import cell_step_flops, train_step_flops

    cfg = TrackerConfig(train=TrainConfig(batch_size=256, sequence_length=20))
    assert frame_flops(cfg) == counts.frame_flops(ntm)
    assert cell_step_flops(cfg) == counts.cell_step_flops(ntm)
    assert train_step_flops(cfg) == counts.train_step_flops(ntm, 256, 20)
