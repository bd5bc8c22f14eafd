"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA card, carry the ``cuda`` marker and skip elsewhere.
The machine with the card has no JAX, so this file imports only torch and
the port, and runs without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from arrow_tpu_torch.kernels.grouped_sum import (grouped_sum,
                                                 grouped_sum_plain)
from arrow_tpu_torch.kernels.probe import probe, probe_plain


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _rtol(dtype):
    # the atomics reorder f64 additions; f32 is compared with an f64 sum
    return 1e-9 if dtype == torch.float64 else 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("num_segments,dtype", [
    (1, torch.float64), (12, torch.float64), (24, torch.float64),
    (25, torch.float64), (512, torch.float64), (1024, torch.float64),
    (16, torch.float32), (700, torch.float32)])
def test_grouped_sum_matches_plain(num_segments, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(num_segments)
    n = (1 << 20) + 3  # a ragged tail past the 16-byte loads
    v = (torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
         * 1e5).to(dtype)
    g = torch.randint(0, num_segments, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    before = grouped_sum.launches
    got = grouped_sum(v, g, num_segments)
    torch.cuda.synchronize()
    assert grouped_sum.launches == before + 1
    assert got.dtype == dtype and got.shape == (num_segments,)
    torch.testing.assert_close(
        got.double(), grouped_sum_plain(v.double(), g, num_segments),
        atol=0, rtol=_rtol(dtype))
    # a view one element in is not 16-byte aligned: the scalar loop
    got = grouped_sum(v[1:], g[1:], num_segments)
    torch.testing.assert_close(
        got.double(), grouped_sum_plain(v[1:].double(), g[1:], num_segments),
        atol=0, rtol=_rtol(dtype))


@pytest.mark.cuda
def test_grouped_sum_inf_nan_and_empty_groups():
    _need_card()
    v = torch.ones(10_000, dtype=torch.float64, device="cuda")
    g = (torch.arange(10_000, device="cuda") % 4).to(torch.int32)
    v[5], v[6] = float("inf"), float("nan")  # groups 1 and 2
    got = grouped_sum(v, g, 8).cpu()
    assert got[0] == 2500.0 and got[3] == 2500.0
    assert torch.isinf(got[1]) and torch.isnan(got[2])
    assert torch.all(got[4:] == 0.0)


@pytest.mark.cuda
def test_grouped_sum_rejects_mixed_devices():
    _need_card()
    with pytest.raises(ValueError):
        grouped_sum(torch.ones(8, dtype=torch.float64, device="cuda"),
                    torch.zeros(8, dtype=torch.int32), 4)


@pytest.mark.cuda
def test_probe_matches_plain():
    _need_card()
    x = torch.randn(8, 128, device="cuda")
    before = probe.launches
    y = probe(x)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(y, probe_plain(x))
