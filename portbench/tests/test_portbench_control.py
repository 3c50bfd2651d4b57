"""The control on the card: the reference computed in TF32 (the nearest
precision below the configurations' float32 with TF32 off) in the
program's place, at each cell's own size, on three seeds, has to come out
not correct against the cell's limits, while the program on the same
seeds comes out correct. Needs the card (about 10 minutes for the four
cells): `python3 -m pytest portbench/tests -q -m card`."""

import json

import pytest
import torch

from portbench import harness
from portbench.tools.readings import readings

SEEDS = (4_100_000_001, 4_100_000_002, 4_100_000_003)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in harness.manifest()["workloads"]])
def test_the_control_fails_and_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    limits = harness.make_run(harness.manifest(), workload, 1, 1.0, False, "cpu").limits
    for seed in SEEDS:
        r = readings(workload, seed, 3.0, control=True)
        print(json.dumps({k: r[k] for k in ("seed", "program", "control")}))
        assert all(r["program"][k] <= v["limit"] for k, v in limits.items()), r
        assert any(r["control"][k] > v["limit"] for k, v in limits.items()), r
