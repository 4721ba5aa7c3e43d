"""The control at a tiny size: the reference with its capacities cut at
the pool's 99th percentile must come out not correct, on every seed and
in every cell, and the sound reference must come out correct."""

import numpy as np
import pytest

from benchmark import compare, control, data, reference
from benchmark.tests import tiny

CELLS = tiny.cells("batched_2hop")  # the control is the batched 2-hop's


@pytest.mark.parametrize("seed", [3, 2**31 + 1, 977])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, seed):
    checks, failed, (cap1, cap2) = control.run_control(tiny.cell(name), seed, tiny.CPU)
    assert not compare.is_correct(checks)
    assert failed > 0 and checks["count_mismatch"]["value"] > 0
    assert cap1 > 0 and cap2 > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_reference_is_correct(name):
    cell = tiny.cell(name)
    inputs = data.build_inputs(cell.config, cell.traffic, 5, tiny.CPU)
    csr = reference.build_csr(inputs.src, inputs.dst, inputs.n_nodes)
    ref = reference.answers(csr, inputs.pool)
    q = cell.traffic["batch"]
    done = [(np.arange(b, b + q), (ref[0] + ref[1])[b:b + q].astype(np.int32),
             ref[2][b:b + q]) for b in range(0, len(inputs.pool), q)]
    sampled = [(i, reference.two_hop_set(csr, inputs.pool[i])[2], int(ref[1][i]))
               for i in range(len(inputs.pool) - q, len(inputs.pool))]
    checks, failed = compare.compare(csr, inputs.pool, ref, done, sampled)
    assert compare.is_correct(checks) and failed == 0
