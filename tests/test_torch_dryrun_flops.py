"""The dry-run account's matmul FLOPs against the reference's HLO
analysis (``tests/torch_dryrun_flops.py``): for the dense archs yi-6b and
phi3, one reduced train step (batch 8 × 64, bf16, remat) counts within 2%
of ``analyze_hlo(...).dot_flops`` (they are equal on this tree).  The
other archs' ratios, from the same script, are in PERF.md."""

import pytest
import torch

from torch_dryrun_flops import port_matmul_flops, reference_dot_flops

torch.set_num_threads(1)

TOL = 0.02  # relative


@pytest.mark.parametrize("arch", ["yi_6b", "phi3_mini_3_8b"])
def test_dense_train_flops_match_hlo_analysis(arch):
    port, ref = port_matmul_flops(arch), reference_dot_flops(arch)
    assert ref > 0 and abs(port - ref) <= TOL * ref, (port, ref)
