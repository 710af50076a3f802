"""PyTorch port: the CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (see README, "PyTorch / CUDA port"). Every
test needs a CUDA device and skips without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu_torch.ops import cc_cuda, labeling
from arcadia_microscopy_tools_tpu_torch.ops.fused import fused_classical_mask
from arcadia_microscopy_tools_tpu_torch.testing import serpentine, synthetic_wells


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cases(device) -> dict[str, torch.Tensor]:
    wells = torch.from_numpy(synthetic_wells(2, 1, 1000, 1500, 60, seed=1)[:, 0]).to(device)
    blobs = fused_classical_mask(wells)
    return {
        "ragged blobs": blobs,
        "serpentine": torch.from_numpy(serpentine(np.zeros((256, 384), bool)))[None].to(device),
        "empty": torch.zeros((1, 256, 256), dtype=torch.bool, device=device),
        "full": torch.ones((1, 256, 256), dtype=torch.bool, device=device),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity", [1, 2])
def test_kernels_match_plain_bit_for_bit(cuda_device, connectivity):
    rng = np.random.default_rng(0)
    for name, fg in _cases(cuda_device).items():
        out = cc_cuda.local_cc(fg, connectivity)
        torch.testing.assert_close(
            out, cc_cuda.local_cc_plain(fg, connectivity), rtol=0, atol=0, msg=name
        )
        init = torch.from_numpy(rng.integers(0, fg[0].numel(), tuple(fg.shape), dtype=np.int32))
        init = init.to(cuda_device)
        out = cc_cuda.local_resweep(fg, init, connectivity)
        torch.testing.assert_close(
            out, cc_cuda.local_resweep_plain(fg, init, connectivity), rtol=0, atol=0, msg=name
        )
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_wrappers_count_launches_and_reject_bad_input(cuda_device):
    cc_cuda.reset_launch_counts()
    fg = torch.ones((1, 64, 64), dtype=torch.bool, device=cuda_device)
    cc_cuda.local_cc(fg)
    cc_cuda.local_resweep(fg, torch.zeros((1, 64, 64), dtype=torch.int32, device=cuda_device))
    assert cc_cuda.launch_counts == {"local_cc": 1, "local_resweep": 1}
    with pytest.raises(ValueError):
        cc_cuda.local_cc(torch.ones((1, 64, 128), dtype=torch.bool, device=cuda_device)[:, :, ::2])


@pytest.mark.gpu
def test_component_roots_on_the_card_equal_the_cpu(cuda_device):
    fg = _cases(cuda_device)["ragged blobs"]
    roots, converged = labeling.component_roots(fg)
    ref_roots, ref_converged = labeling.component_roots(fg.cpu())
    assert torch.equal(roots.cpu(), ref_roots) and torch.equal(converged.cpu(), ref_converged)
