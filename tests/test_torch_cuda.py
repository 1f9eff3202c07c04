"""The hand-written CUDA kernels against their plain versions, on the card.

These need a CUDA device and skip without one (the kernels have no CPU
mode); this file imports only torch, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerance: max |kernel - plain| <= tol * max |plain|, tol 5e-5 for f32 (the
order of f32 sums) and 2^-7 for bf16 (one bf16 rounding of the output).
"""
import pytest
import torch

from repro_torch.kernels.fused import fused_matmul
from repro_torch.kernels.packed_matmul import packed_matmul


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,m,k,l,r",
    [
        (8, 1, 3584, 512, 16),   # decode: thin tile, split K
        (1, 70, 300, 200, 8),    # K not a multiple of 8: FMA tile
        (3, 17, 64, 33, 24),     # rows of several adapters in one tile
        (1, 100, 256, 64, 24),   # bf16: tensor-core tile, split K, rank padded to 32
        (2, 128, 512, 192, 16),  # bf16: tensor-core tile, one adapter per 64 rows
    ],
)
def test_cuda_kernels_match_plain(cuda, dtype, n, m, k, l, r):
    from repro_torch.kernels.ref import fused_matmul_ref, packed_matmul_ref

    g = torch.Generator(device=cuda).manual_seed(0)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    x = torch.randn((n, m, k), generator=g, device=cuda).to(dt)
    w = (torch.randn((k, l), generator=g, device=cuda) * k ** -0.5).to(dt)
    a = (torch.randn((n, k, r), generator=g, device=cuda) * k ** -0.5).to(dt)
    b = torch.randn((n, r, l), generator=g, device=cuda).to(dt)
    s = torch.linspace(0.5, 2.0, n, device=cuda)
    tol = 5e-5 if dtype == "float32" else 2 ** -7
    n0 = packed_matmul.launches
    got, want = packed_matmul(x, a, s), packed_matmul_ref(x, a, s)
    assert packed_matmul.launches == n0 + 1
    assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()
    got, want = fused_matmul(x, w, a, b, s), fused_matmul_ref(x, w, a, b, s)
    assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()
    strided = torch.empty((n, m, 2 * k), device=cuda, dtype=dt)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        packed_matmul(strided, a, s)
