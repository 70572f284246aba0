"""The control, the reference with its products in fp8 put in the
program's place, comes out not correct: one of a cell's numbers reads
above its limit. On the CPU at a tiny size; on the card at the cells' own
sizes on three seeds (marked ``gpu``: it skips where there is no card)."""

import pytest
import torch

from benchmark import harness, readings
from benchmark.tests import tiny

CARD_SEEDS = (3400000001, 3400000002, 3400000003)


def _fails(workload, readings_):
    lim = harness.limits(workload)
    return {what: any(v > lim[k] for k, v in r.items())
            for what, r in readings_}


@pytest.mark.parametrize("workload", ["resnext_train_b512",
                                      "resnext_embed_b256"])
def test_the_control_fails_at_a_tiny_size(workload):
    torch.set_num_threads(2)
    cfg, tr = tiny.sized(workload)
    got = _fails(workload, readings.control_readings(
        workload, tiny.SEED, "cpu", cfg, tr))
    assert got["control_fp8"]
    if "fault_half_batch" in got:
        assert got["fault_half_batch"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.spec()["workloads"]])
def test_the_control_fails_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in CARD_SEEDS:
        got = _fails(workload, readings.control_readings(workload, seed,
                                                         "cuda"))
        assert all(got.values()), (seed, got)
