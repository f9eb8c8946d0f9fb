"""The four Q4_K kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU (sm_90a) and nvcc; they skip elsewhere. The
file imports only the port (no JAX), so it also runs on a machine without
JAX: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from ctransformers_tpu_torch.ops import qmm_kernels as K
from ctransformers_tpu_torch.ops.qmatmul import QTensor, qmatmul, select_mode

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    K.build()
    return torch.device("cuda")


def random_q4k(k: int, n: int, seed: int, device) -> QTensor:
    """A Q4_K QTensor with random planes at padded shape (k, n)."""
    g = torch.Generator().manual_seed(seed)
    qs = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8)
    sub_s = torch.randint(0, 64, (k // 32, n), generator=g, dtype=torch.int8)
    sub_m = torch.randint(0, 64, (k // 32, n), generator=g, dtype=torch.int8)
    sd = torch.rand((k // 256, n), generator=g) * 1e-3 + 1e-4
    sm = -torch.rand((k // 256, n), generator=g) * 1e-3
    return QTensor(
        qs, sub_s, sub_m, "Q4_K", 32, (k, n), packed=True, zp=0,
        sd=sd, sm=sm, sfactor=8, pack_layout="adjk",
    ).to(device)


def _rel(a, b):
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


# q/qx: the integer group dots are exact, only the f32 rescale sums differ
# in order; i/si: bf16 products summed in another order on tensor cores
TOL = {"qmm_qx": 1e-5, "qmm_q": 1e-5, "qmm_si": 1e-3, "qmm_i": 1e-3}


@pytest.mark.parametrize("name", sorted(TOL))
@pytest.mark.parametrize("k,n", [(256, 384), (1024, 256), (2048, 1152)])
@pytest.mark.parametrize("m", [1, 3, 8, 33, 64, 130])
def test_kernel_matches_plain(dev, name, k, n, m):
    qt = random_q4k(k, n, seed=k + n + m, device=dev)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(dev)
    args = K.quantize_activations(x) if name == "qmm_q" else (x,)
    before = K.LAUNCHES[name]
    got = K.KERNELS[name](*args, qt)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    ref = K.PLAIN[name](*args, qt)
    assert got.shape == ref.shape == (m, n)
    assert _rel(got, ref) <= TOL[name], name
    again = K.KERNELS[name](*args, qt)
    assert torch.equal(got, again), "kernel runs are not bitwise repeatable"


def test_qmatmul_routes_every_mode(dev):
    # logical (500, 1000) inside padded (512, 1024) planes
    qt = dataclasses.replace(random_q4k(512, 1024, seed=1, device=dev), shape=(500, 1000))
    K.reset_counts()
    for m in (1, 8, 64):
        out = qmatmul(torch.randn(m, 500, device=dev), qt)
        assert out.shape == (m, 1000) and torch.isfinite(out).all()
    assert select_mode(64, 512, 1024) == "si"
    assert K.LAUNCHES == {"qmm_qx": 1, "qmm_q": 1, "qmm_si": 1, "qmm_i": 0}
    assert sum(K.PLAIN_CALLS.values()) == 0


def test_wrapper_rejects_bad_operands(dev):
    qt = random_q4k(256, 128, seed=2, device=dev)
    with pytest.raises(ValueError):
        K.qmm_qx(torch.randn(1, 256, device=dev, dtype=torch.float64), qt)
    with pytest.raises(ValueError):
        K.qmm_si(torch.randn(4, 256), qt)  # CPU activations, CUDA weight
