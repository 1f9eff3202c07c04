"""The hand-written CUDA kernels against their plain versions, on the card.

These need a CUDA device and skip without one (the kernels have no CPU
mode); this file imports only torch, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerance: max |kernel - plain| <= tol * max |plain|, tol 5e-5 for f32 (the
order of f32 sums) and 2^-7 for bf16 (one bf16 rounding of the output).
The quantized fused kernel is held bit-equal to the dense one on the
dequantized weight (``torch.equal``): the two stage identical tile values.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import launches, ops
from repro_torch.kernels.fused import (
    fused_matmul,
    fused_matmul_path,
    fused_matmul_q,
    fused_matmul_q_path,
)
from repro_torch.kernels.packed_matmul import packed_matmul, packed_matmul_pair, packed_matmul_path
from repro_torch.kernels.quant import dequantize, quantize_weight
from repro_torch.kernels.ref import fused_matmul_q_ref, fused_matmul_ref, packed_matmul_ref

TOL = {torch.float32: 5e-5, torch.bfloat16: 2 ** -7}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(g, shape, dt, std=1.0):
    return (torch.randn(shape, generator=g, device=g.device) * std).to(dt)


def _n(count):
    """A launch count of ``kernels/launches.py`` (forward or backward, all paths)."""
    return launches.read()[count]


def _close(got, want):
    err = (got.float() - want.float()).abs().max()
    assert torch.isfinite(got.float()).all()
    assert err <= TOL[want.dtype] * want.float().abs().max(), float(err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,m,k,l,r",
    [
        (8, 1, 3584, 512, 16),   # decode: f32 thin tile, split K; bf16: the decode kernels
        (1, 70, 300, 200, 8),    # K not a multiple of 8: FMA tile
        (3, 17, 64, 33, 24),     # rows of several adapters in one tile
        (1, 100, 256, 64, 24),   # bf16: tensor-core tile, split K, rank padded to 32
        (2, 128, 512, 192, 16),  # bf16: tensor-core tile, one adapter per 64 rows
    ],
)
def test_cuda_kernels_match_plain(cuda, dtype, n, m, k, l, r):
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = DTYPES[dtype]
    x = _rnd(g, (n, m, k), dt)
    w = _rnd(g, (k, l), dt, k ** -0.5)
    a = _rnd(g, (n, k, r), dt, k ** -0.5)
    b = _rnd(g, (n, r, l), dt)
    s = torch.linspace(0.5, 2.0, n, device=cuda)
    n0 = _n("packed_matmul")
    got, want = packed_matmul(x, a, s), packed_matmul_ref(x, a, s)
    assert _n("packed_matmul") == n0 + 1
    _close(got, want)
    _close(fused_matmul(x, w, a, b, s), fused_matmul_ref(x, w, a, b, s))
    strided = torch.empty((n, m, 2 * k), device=cuda, dtype=dt)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        packed_matmul(strided, a, s)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,t,d,k,r",
    [
        (2, 1, 96, 40, 8),        # one token per adapter
        (1, 130, 200, 72, 128),   # the largest rank, ragged edges
        (3, 64, 256, 120, 16),
        (2, 256, 512, 384, 32),   # long contraction over tokens: split K
    ],
)
def test_backward_cases_match_plain(cuda, dtype, n, t, d, k, r):
    """The four backward cases of the two-pass delta: the grouped kernel on
    transposed views, read in place."""
    g = torch.Generator(device=cuda).manual_seed(1)
    dt = DTYPES[dtype]
    x, a = _rnd(g, (n, t, d), dt), _rnd(g, (n, d, r), dt, d ** -0.5)
    b, gs = _rnd(g, (n, r, k), dt), _rnd(g, (n, t, k), dt)
    xa, dxa = _rnd(g, (n, t, r), dt), _rnd(g, (n, t, r), dt)
    n0 = _n("packed_matmul_bwd")
    for lhs, rhs in ((xa.transpose(1, 2), gs), (gs, b.transpose(1, 2)),
                     (x.transpose(1, 2), dxa), (dxa, a.transpose(1, 2))):
        _close(packed_matmul(lhs, rhs, backward=True), packed_matmul_ref(lhs, rhs))
    assert _n("packed_matmul_bwd") == n0 + 4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,m,d_in,d_out,r",
    [
        (2, 128, 256, 192, 16),  # bf16: tensor-core tile, W^T staged column by column
        (1, 70, 96, 40, 8),      # tensor-core tile with ragged rows / FMA tile
        (3, 5, 64, 48, 24),      # FMA tile, rows of several adapters per tile
    ],
)
def test_fused_dx_reads_w_transposed(cuda, dtype, n, m, d_in, d_out, r):
    """dx = g @ W^T + s * (g @ B^T) @ A^T through the fused kernel, W^T a
    transposed view of W: no copy."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    dt = DTYPES[dtype]
    g = _rnd(gen, (n, m, d_out), dt)
    w = _rnd(gen, (d_in, d_out), dt, d_in ** -0.5)
    bt = _rnd(gen, (n, r, d_out), dt).transpose(1, 2).contiguous()
    at = _rnd(gen, (n, d_in, r), dt, d_in ** -0.5).transpose(1, 2).contiguous()
    s = torch.linspace(0.5, 2.0, n, device=cuda)
    n0 = _n("fused_matmul_dx")
    _close(fused_matmul(g, w.t(), bt, at, s, backward=True), fused_matmul_ref(g, w.t(), bt, at, s))
    assert _n("fused_matmul_dx") == n0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "nf4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,m,k,l,r",
    [
        (2, 128, 256, 192, 16),   # bf16: tensor-core tile
        (1, 100, 512, 64, 24),    # bf16: tensor-core tile with split K
        (8, 1, 384, 80, 16),      # decode rows: bf16 the decode kernel, f32 FMA tile
        (3, 17, 96, 40, 8),       # FMA tile
    ],
)
def test_fused_q_bit_equal_to_dense_on_dequantized(cuda, mode, dtype, n, m, k, l, r):
    g = torch.Generator(device=cuda).manual_seed(3)
    dt = DTYPES[dtype]
    x, a, b = _rnd(g, (n, m, k), dt), _rnd(g, (n, k, r), dt, k ** -0.5), _rnd(g, (n, r, l), dt)
    q = quantize_weight(_rnd(g, (k, l), torch.float32, k ** -0.5), mode)
    s = torch.linspace(0.5, 2.0, n, device=cuda)
    n0 = _n("fused_matmul_q")
    got = fused_matmul_q(x, q["codes"], q["scales"], a, b, s)
    assert _n("fused_matmul_q") == n0 + 1
    assert torch.equal(got, fused_matmul(x, dequantize(q, dt), a, b, s))
    _close(got, fused_matmul_q_ref(x, q["codes"], q["scales"], a, b, s))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,m,k,l,r,scaled",
    [
        (3, 64, 200, 136, 8, True),     # two adapters per 128-row block; K, L off the tile
        (2, 192, 328, 264, 16, False),  # block 1 spans both adapters; scale=None
        (2, 64, 256, 200, 32, True),
        (2, 128, 256, 256, 12, True),   # rank not a multiple of 8: A staged by threads
        (1, 300, 136, 520, 128, True),  # rows off the tile; the widest rank, 128-wide tile
        (2, 128, 4096, 256, 16, True),  # few output tiles: K split in 16 ranges
        # ragged packs (M % 64 != 0): row tiles per adapter, the last one's
        # rows past the adapter's end not stored
        (3, 100, 200, 136, 16, True),
        (2, 200, 256, 200, 12, True),    # M % 128 > 64; A staged by threads
        (4, 40, 128, 264, 128, False),   # M < 64: one tile an adapter, its second slab idle
        (2, 1500, 384, 384, 12, True),   # whisper-tiny's encoder rows
        (2, 1500, 384, 1536, 16, True),
        (2, 1500, 1536, 384, 128, True),
        (3, 100, 4096, 256, 16, True),   # 3 row tiles: K split in 16 ranges
    ],
)
def test_wgmma_path_matches_plain(cuda, n, m, k, l, r, scaled):
    """bf16 training-like shapes take the warp-specialised wgmma kernel,
    ragged packs too: the forward and dx (W^T read in place) against the
    plain versions, and int8/nf4 bit-equal to the dense kernel on the
    dequantized W."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    dt = torch.bfloat16
    x, w = _rnd(gen, (n, m, k), dt), _rnd(gen, (k, l), dt, k ** -0.5)
    a, b = _rnd(gen, (n, k, r), dt, k ** -0.5), _rnd(gen, (n, r, l), dt)
    s = torch.linspace(0.5, 2.0, n, device=cuda) if scaled else None
    assert fused_matmul_path(x, w, r) == "wgmma"
    _close(fused_matmul(x, w, a, b, s), fused_matmul_ref(x, w, a, b, s))
    w_store = _rnd(gen, (l, k), dt, k ** -0.5)  # dx reads its transpose in place
    assert fused_matmul_path(x, w_store.t(), r) == "wgmma"
    _close(fused_matmul(x, w_store.t(), a, b, s, backward=True),
           fused_matmul_ref(x, w_store.t(), a, b, s))
    for mode in ("int8", "nf4"):
        q = quantize_weight(_rnd(gen, (k, l), torch.float32, k ** -0.5), mode)
        assert fused_matmul_q_path(x, q["codes"], q["scales"], r) == "wgmma"
        got = fused_matmul_q(x, q["codes"], q["scales"], a, b, s)
        assert torch.equal(got, fused_matmul(x, dequantize(q, dt), a, b, s))
        _close(got, fused_matmul_q_ref(x, q["codes"], q["scales"], a, b, s))


@pytest.mark.gpu
def test_wgmma_split_k_is_deterministic_and_paths_follow_shapes(cuda):
    """A split-K call gives the same bits twice (fixed-order partial sums),
    a ragged pack's too; bf16 decode rows take the weight-streaming kernel,
    f32 and the backward's W^T at decode rows the three-launch path, bf16
    training rows the wgmma kernel (a pack of 2 x 1,000 rows, no multiple
    of 64, included), f32 training rows the tiled FFMA kernel."""
    from repro_torch.kernels.fused import fused_matmul_splits

    gen = torch.Generator(device=cuda).manual_seed(9)
    dt = torch.bfloat16
    x, w = _rnd(gen, (2, 1024, 3584), dt), _rnd(gen, (3584, 512), dt, 3584 ** -0.5)
    a, b = _rnd(gen, (2, 3584, 16), dt, 3584 ** -0.5), _rnd(gen, (2, 16, 512), dt)
    s = torch.tensor([0.5, 2.0], device=cuda)
    assert fused_matmul_path(x, w, 16) == "wgmma"
    assert torch.equal(fused_matmul(x, w, a, b, s), fused_matmul(x, w, a, b, s))
    xr = x[:, :1000].contiguous()
    assert fused_matmul_path(xr, w, 16) == "wgmma"
    assert fused_matmul_splits(xr, w, 16) > 1
    assert torch.equal(fused_matmul(xr, w, a, b, s), fused_matmul(xr, w, a, b, s))
    assert fused_matmul_path(x[:, :1], w, 16) == "decode"  # 2 rows, bf16
    assert fused_matmul_path(x[:, :1].float(), w.float(), 16) == "split3"  # 2 rows, f32
    assert fused_matmul_path(x[:, :1], w.t().contiguous().t(), 16) == "split3"  # dx's W^T
    assert fused_matmul_path(x.float(), w.float(), 16) == "ffma"


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,d_in,d_out,r", [(3, 100, 384, 392, 16), (2, 1500, 384, 384, 12)])
def test_ragged_pack_rows_equal_each_adapter_alone(cuda, n, m, d_in, d_out, r):
    """In a ragged pack (M % 64 != 0, row tiles per adapter) each adapter's
    rows are, bit for bit, its own call alone (flat tiles, zeros past its
    end): forward, dx and int8, where both plans take one K range (K <=
    448: fewer than 8 K steps)."""
    from repro_torch.kernels.fused import fused_matmul_splits

    gen = torch.Generator(device=cuda).manual_seed(31)
    dt = torch.bfloat16
    (fwd, _), (dx, _) = _train_operands(gen, dt, n, m, d_in, d_out, r, cuda)
    q = quantize_weight(_rnd(gen, (d_in, d_out), torch.float32, d_in ** -0.5), "int8")

    def int8(x, w, a, b, s):
        return fused_matmul_q(x, q["codes"], q["scales"], a, b, s)

    def path(name, x, w):
        if name == "int8":
            return fused_matmul_q_path(x, q["codes"], q["scales"], r)
        return fused_matmul_path(x, w, r)

    calls = {"fwd": (fused_matmul, fwd), "dx": (functools.partial(fused_matmul, backward=True), dx),
             "int8": (int8, fwd)}
    for name, (fn, (x, w, a, b, s)) in calls.items():
        packed = fn(x, w, a, b, s)
        for i in range(n):
            xi, ai, bi, si = (t[i:i + 1].clone() for t in (x, a, b, s))
            for xs in (x, xi):
                assert path(name, xs, w) == "wgmma", name
                assert fused_matmul_splits(xs, w, r) == 1, name
            assert torch.equal(packed[i:i + 1], fn(xi, w, ai, bi, si)), (name, i)


# sha256 of #2/#3's bf16 "wgmma" outputs on flat row tiles (N == 1 or M %
# 64 == 0), from the kernel before ragged packs took the wgmma path: their
# grid, tiles and K ranges, and so their bits, must not move
WGMMA_FLAT_BITS = {
    '1x300x1024x520x16:fwd': '6aad144a5a3087ee0cbde812a581442bb534976d771fdb09c5777c3c050ac8f2',
    '1x300x1024x520x16:dx': '2b2decc0291ccd83ba45d423a7230cfc6d09579ccaa456866b3339b86a02879d',
    '1x300x1024x520x16:int8': '9590af7480b259c68da2b8ef79f6276ae3ad6132e057822c848291e5aaff6d26',
    '1x300x1024x520x16:nf4': '67bef351d4bed0bb86cc93a791302e3f894c4b077dda84d1c33bb745b9df2c42',
    '3x64x200x136x8:fwd': '47cb2ebabd1013280547ca45154d1df55df96a72ed8e48b7a710848411e08ce5',
    '3x64x200x136x8:dx': '1aa4984b00d8d4b12f7fdde673e0f12097985d6f57e148eff080eb8f43043866',
    '3x64x200x136x8:int8': '90f822640b07efc72d4cfad5733af9bed2a4bc470a6ffe064d5cc68388147f80',
    '3x64x200x136x8:nf4': '7d49887b6db5ff235618274ea9d061533190b3011c61c2868b75717dcba8206e',
    '2x128x4096x256x16:fwd': '7c4387104b970384874e214e0055c23bfa0c9e35af39693998a741e8a6615b4f',
    '2x128x4096x256x16:dx': 'fd6e3a162bce92a0078be9202c2cda44be15328343760ba2345598eed8b937e3',
    '2x128x4096x256x16:int8': 'd9134caec10c539fd4bce13cdb10d363e7c15a7d4ad735624c81918a3452b778',
    '2x128x4096x256x16:nf4': '7bc66a95a1b83564f4b0fc4444c0e7d1dfa002f387e271c89b0a1af09cdf85f0',
    '2x1024x3584x512x16:fwd': 'ee704debb61e994b44ef18076671a6dbeef2211802d7f1bd58de36cfd8a932b8',
    '2x1024x3584x512x16:dx': '62f625631466e993046e92847b43504ba34c94fb70c0100ea4669712754abf58',
    '2x1024x3584x512x16:int8': '27c50ecca5af401ccf81dc2c3cfb6538ce012183ec6fd1bb6775568605d96065',
    '2x1024x3584x512x16:nf4': '746426a4e4ec26e87e1874217e27b4b94cdea96f900db2c445ce7d4f8a87d723',
}
# (n, m, k, l, r): one adapter with a ragged edge, slabs of two adapters
# in one tile, a K split in 16 ranges, the training shape's k/v
WGMMA_FLAT_CASES = [(1, 300, 1024, 520, 16), (3, 64, 200, 136, 8), (2, 128, 4096, 256, 16),
                    (2, 1024, 3584, 512, 16)]


@pytest.mark.gpu
def test_wgmma_flat_rows_keep_their_bits(cuda):
    """#2's forward and dx and #3's int8/nf4 on the wgmma kernel's flat row
    tiles, on inputs drawn on the CPU from a seed: the same bits as before
    ragged packs took that kernel."""
    import hashlib

    gen = torch.Generator().manual_seed(81)

    def rnd(shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(cuda, torch.bfloat16)

    bits = {}
    for n, m, k, l, r in WGMMA_FLAT_CASES:
        x, w = rnd((n, m, k)), rnd((k, l), k ** -0.5)
        a, b, g = rnd((n, k, r), k ** -0.5), rnd((n, r, l)), rnd((n, m, l))
        s = torch.linspace(0.5, 2.0, n, device=cuda)
        wt = rnd((k, l), k ** -0.5)  # dx reads W^T of a (k, l) W: a (m, l) g into k columns
        ys = {"fwd": fused_matmul(x, w, a, b, s),
              "dx": fused_matmul(g, wt.t(), b.transpose(1, 2).contiguous(),
                                 a.transpose(1, 2).contiguous(), s, backward=True)}
        for mode in ("int8", "nf4"):
            q = quantize_weight(w.float(), mode)
            ys[mode] = fused_matmul_q(x, q["codes"], q["scales"], a, b, s)
        assert fused_matmul_path(x, w, r) == fused_matmul_path(g, wt.t(), r) == "wgmma"
        for name, y in ys.items():
            bits[f"{n}x{m}x{k}x{l}x{r}:{name}"] = hashlib.sha256(
                y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    print(bits)
    assert bits == WGMMA_FLAT_BITS


# qwen25-7b's projections (d_in, d_out): q and o, k and v, gate and up, down
TRAIN_PROJ = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)]


def _ffma_call(fn, *args, backward=False):
    """One fused call that must take the ffma path: counted once, under its
    direction and "ffma"; returns its result."""
    want = dict(fused_matmul.launches)
    want["bwd" if backward else "fwd", "ffma"] += 1
    y = fn(*args, backward=backward)
    assert fused_matmul.launches == want
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("d_in,d_out", TRAIN_PROJ)
def test_ffma_path_at_the_training_shapes(cuda, d_in, d_out):
    """f32 at qwen25-7b's training shapes (N = 2 x M = 1,024, r = 16): the
    forward and dx (W^T read in place from W's storage) take the tiled
    FFMA kernel and agree with the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(40)
    n, m, r, f32 = 2, 1024, 16, torch.float32
    w = _rnd(gen, (d_in, d_out), f32, d_in ** -0.5)
    s = torch.tensor([0.5, 2.0], device=cuda)
    x, a, b = _rnd(gen, (n, m, d_in), f32), _rnd(gen, (n, d_in, r), f32, d_in ** -0.5), \
        _rnd(gen, (n, r, d_out), f32)
    assert fused_matmul_path(x, w, r, a, b) == "ffma"
    _close(_ffma_call(fused_matmul, x, w, a, b, s), fused_matmul_ref(x, w, a, b, s))
    g, bt = _rnd(gen, (n, m, d_out), f32), b.transpose(1, 2).contiguous()
    at = a.transpose(1, 2).contiguous()
    assert fused_matmul_path(g, w.t(), r, bt, at) == "ffma"
    _close(_ffma_call(fused_matmul, g, w.t(), bt, at, s, backward=True),
           fused_matmul_ref(g, w.t(), bt, at, s))


@pytest.mark.gpu
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("r", [8, 16, 20, 64, 128])
def test_ffma_path_matches_plain(cuda, r, n, scaled):
    """f32 with ragged edges everywhere: M = 304 (one adapter) or 300 (three,
    whose rows share 128-row tiles), K = L = 3,592 (a partial column tile
    and a partial K step); forward and dx, and int8/nf4 ``torch.equal`` to
    the dense kernel on the dequantized W (the same path and sums)."""
    gen = torch.Generator(device=cuda).manual_seed(41 + r)
    m, k, f32 = (304 if n == 1 else 300), 3592, torch.float32
    x, w = _rnd(gen, (n, m, k), f32), _rnd(gen, (k, k), f32, k ** -0.5)
    a, b = _rnd(gen, (n, k, r), f32, k ** -0.5), _rnd(gen, (n, r, k), f32)
    s = torch.linspace(0.5, 2.0, n, device=cuda) if scaled else None
    assert fused_matmul_path(x, w, r, a, b) == "ffma"
    y = _ffma_call(fused_matmul, x, w, a, b, s)
    assert y.shape == (n, m, k) and y.is_contiguous()
    _close(y, fused_matmul_ref(x, w, a, b, s))
    bt, at = b.transpose(1, 2).contiguous(), a.transpose(1, 2).contiguous()
    _close(_ffma_call(fused_matmul, x, w.t(), bt, at, s, backward=True),
           fused_matmul_ref(x, w.t(), bt, at, s))
    for mode in ("int8", "nf4"):
        q = quantize_weight(w, mode)
        assert fused_matmul_q_path(x, q["codes"], q["scales"], r, a, b) == "ffma"
        n0 = fused_matmul_q.launches["fwd", "ffma"]
        got = fused_matmul_q(x, q["codes"], q["scales"], a, b, s)
        assert fused_matmul_q.launches["fwd", "ffma"] == n0 + 1
        assert torch.equal(got, fused_matmul(x, dequantize(q, f32), a, b, s))
        _close(got, fused_matmul_q_ref(x, q["codes"], q["scales"], a, b, s))


@pytest.mark.gpu
def test_ffma_split_k_is_deterministic_and_captures(cuda):
    """k/v's shape leaves SMs idle (few output tiles): K is split, and the
    call gives the same bits twice. A call captured in a CUDA graph (the
    launcher's step) replays to the eager call's bits, forward and dx."""
    from repro_torch.kernels import fused as fused_module

    gen = torch.Generator(device=cuda).manual_seed(42)
    n, m, k, l, r, f32 = 2, 1024, 3584, 512, 16, torch.float32
    x, w = _rnd(gen, (n, m, k), f32), _rnd(gen, (k, l), f32, k ** -0.5)
    a, b = _rnd(gen, (n, k, r), f32, k ** -0.5), _rnd(gen, (n, r, l), f32)
    s = torch.tensor([0.5, 2.0], device=cuda)
    path, n_ws = fused_module._plan("fused", n, m, k, l, r, 0, 1, 1, 0)
    assert fused_module.PATHS[path] == "ffma" and n_ws > n * m * l  # the base's partials
    y = fused_matmul(x, w, a, b, s)
    assert torch.equal(y, fused_matmul(x, w, a, b, s))
    _close(y, fused_matmul_ref(x, w, a, b, s))
    g, bt, at = _rnd(gen, (n, m, l), f32), b.transpose(1, 2).contiguous(), \
        a.transpose(1, 2).contiguous()
    for args, bwd in (((x, w, a, b, s), False), ((g, w.t(), bt, at, s), True)):
        eager = fused_matmul(*args, backward=bwd)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fused_matmul(*args, backward=bwd)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fused_matmul(*args, backward=bwd)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


# plan_ffma's K ranges at the training launcher's shapes (each same-rank
# segment of its pack: N = 1 x M = 1,024), forward and dx, by (d_in, d_out)
LAUNCHER_SPLITS = {(3584, 3584): (4, 4), (3584, 512): (4, 1), (3584, 18944): (1, 4),
                   (18944, 3584): (4, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("r", [8, 16])
@pytest.mark.parametrize("d_in,d_out", TRAIN_PROJ)
def test_ffma_at_the_launcher_shapes_splits_k_four_ways(cuda, d_in, d_out, r):
    """At the launcher's shapes the plan cuts K into 4 ranges (q/o, k/v and
    down forward; q/o and gate/up dx) or none: each call takes the ffma
    path, agrees with the plain version and gives the same bits twice."""
    from repro_torch.kernels import fused as fused_module

    gen = torch.Generator(device=cuda).manual_seed(43 + r)
    n, m, f32 = 1, 1024, torch.float32
    w = _rnd(gen, (d_in, d_out), f32, d_in ** -0.5)
    x, a, b = _rnd(gen, (n, m, d_in), f32), _rnd(gen, (n, d_in, r), f32, d_in ** -0.5), \
        _rnd(gen, (n, r, d_out), f32)
    g, bt, at = _rnd(gen, (n, m, d_out), f32), b.transpose(1, 2).contiguous(), \
        a.transpose(1, 2).contiguous()
    s = torch.tensor([2.0], device=cuda)
    for args, bwd, splits in (((x, w, a, b, s), False, LAUNCHER_SPLITS[d_in, d_out][0]),
                              ((g, w.t(), bt, at, s), True, LAUNCHER_SPLITS[d_in, d_out][1])):
        k, l = args[0].shape[2], args[1].shape[1]
        path, n_ws = fused_module._plan("fused", n, m, k, l, r, 0, 1, 1, int(bwd))
        assert fused_module.PATHS[path] == "ffma"
        # the workspace: y's f32 partials, one (M x L) block a K range when K
        # is split, then xA's (at most 17 ranges x r <= 272 columns, < L)
        assert n_ws // (n * m * l) == (splits if splits > 1 else 0)
        y = _ffma_call(fused_matmul, *args, backward=bwd)
        _close(y, fused_matmul_ref(*args))
        assert torch.equal(y, fused_matmul(*args, backward=bwd))


@pytest.mark.gpu
def test_raw_wrappers_raise_on_inputs_that_require_grad(cuda):
    """The kernels' outputs carry no graph: rather than return one that cuts
    the LoRA leaves off the loss, the wrappers raise under grad mode."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x, w = _rnd(g, (2, 8, 32), torch.float32), _rnd(g, (32, 16), torch.float32)
    a = _rnd(g, (2, 32, 8), torch.float32).requires_grad_(True)
    b = _rnd(g, (2, 8, 16), torch.float32)
    q = quantize_weight(w, "int8")
    calls = [lambda: packed_matmul(x, a), lambda: fused_matmul(x, w, a, b),
             lambda: fused_matmul_q(x, q["codes"], q["scales"], a, b)]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["auto", "fused"])
@pytest.mark.parametrize("xdim", [3, 4])
def test_autograd_through_kernels_matches_plain(cuda, impl, xdim):
    """Gradients reach A and B through the kernels' autograd Functions, in
    both branches of the two-pass backward and for a ragged pack, and agree
    with the plain path."""
    g = torch.Generator(device=cuda).manual_seed(5)
    ranks = (8, 16, 8)
    x = _rnd(g, (3, 2, 64, 128) if xdim == 4 else (3, 128, 128), torch.float32)
    w = _rnd(g, (128, 96), torch.float32, 128 ** -0.5)
    al = torch.tensor([2.0, 0.5, 1.0], device=cuda)
    grads = {}
    for path in (impl, "plain" if impl == "auto" else "fused_plain"):
        a = _rnd(torch.Generator(device=cuda).manual_seed(6), (3, 128, 16), torch.float32, 0.1)
        b = _rnd(torch.Generator(device=cuda).manual_seed(7), (3, 16, 96), torch.float32)
        a.requires_grad_(True)
        b.requires_grad_(True)
        n0 = (_n("packed_matmul_bwd"), _n("fused_matmul_dx"))
        if impl == "auto":
            y = ops.packed_lora_delta(x, a, b, al, impl=path, ranks=ranks)
        else:
            y = ops.fused_lora_linear(x, w, a, b, al, impl=path, ranks=ranks)
        (y.float() ** 2).sum().backward()
        if path == impl:
            assert (_n("packed_matmul_bwd"), _n("fused_matmul_dx")) != n0
        assert a.grad is not None and b.grad is not None
        assert (a.grad[0, :, 8:] == 0).all() and (b.grad[2, 8:] == 0).all()
        grads[path] = (a.grad, b.grad)
    for got, want in zip(*grads.values()):
        _close(got, want)


def _operand(g, shape, trans, std=1.0):
    """A bf16 (N, R, C) operand, stored as is or as the transpose of a
    contiguous (N, C, R) tensor (read in place by the kernel)."""
    n, r, c = shape
    if trans:
        return _rnd(g, (n, c, r), torch.bfloat16, std).transpose(1, 2)
    return _rnd(g, shape, torch.bfloat16, std)


@pytest.mark.gpu
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("r", [8, 16, 32, 64, 128])
def test_mma_path_matches_plain(cuda, r, n, scaled):
    """bf16 calls with more than 16 rows take the tensor-core kernels, in
    all four operand layouts, at ragged shapes (M off the 64- and 128-row
    tiles, K = 3592 off the 64-deep step, L = 3592 off the 128-column tile):
    the narrow class (L = r: xA, case 2 reading B^T, case 3 reading x^T) and
    the short-K class (K = r: (xA)B, case 4 reading A^T)."""
    g = torch.Generator(device=cuda).manual_seed(10 + r + n)
    d = 3592
    s = torch.linspace(0.5, 2.0, n, device=cuda) if scaled else None
    for tx in (False, True):
        m = 304 if tx else 300  # a transposed x's rows are its leading dimension
        for tw in (False, True):
            for k, l in ((d, r), (r, d)):  # narrow, short K
                x = _operand(g, (n, m, k), tx)
                w = _operand(g, (n, k, l), tw, k ** -0.5)
                assert packed_matmul_path(x, w) == "mma", (tx, tw, k, l)
                _close(packed_matmul(x, w, s), packed_matmul_ref(x, w, s))


@pytest.mark.gpu
def test_mma_split_k_is_deterministic(cuda):
    """xA and case 2 at the training shapes split K over blocks; the f32
    partial sums are added in a fixed order, so a call gives the same bits
    twice (what remat="save" == "recompute" rests on)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = _rnd(g, (2, 1024, 18944), torch.bfloat16)
    a = _rnd(g, (2, 18944, 16), torch.bfloat16, 18944 ** -0.5)
    bt = _rnd(g, (2, 16, 18944), torch.bfloat16).transpose(1, 2)
    s = torch.tensor([0.5, 2.0], device=cuda)
    for w in (a, bt):
        assert packed_matmul_path(x, w) == "mma"
        assert torch.equal(packed_matmul(x, w, s), packed_matmul(x, w, s))


@pytest.mark.gpu
def test_packed_matmul_path_follows_shapes(cuda):
    """Decode rows take the streaming kernels; ranks off a multiple of 8
    keep the FMA kernel; the bf16 training and prefill calls take the
    tensor-core kernels, the f32 ones the streaming FFMA kernels."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = _rnd(g, (2, 1024, 3584), torch.bfloat16)
    a = _rnd(g, (2, 3584, 16), torch.bfloat16)
    xa, b = _rnd(g, (2, 1024, 16), torch.bfloat16), _rnd(g, (2, 16, 3584), torch.bfloat16)
    assert packed_matmul_path(x, a) == "mma"  # xA
    assert packed_matmul_path(xa, b) == "mma"  # (xA)B
    assert packed_matmul_path(x[:1, :256].contiguous(), a[:1]) == "mma"  # prefill
    assert packed_matmul_path(x[:, :16].contiguous(), a) == "decode"  # 16 rows: decode
    assert packed_matmul_path(x.float(), a.float()) == "f32skinny"  # f32
    a12 = _rnd(g, (2, 3584, 12), torch.bfloat16)
    assert packed_matmul_path(x, a12) == "fma"  # rank 12
    assert packed_matmul_path(xa.transpose(1, 2), x) == "fma"  # case 1: rows = rank, long K


@pytest.mark.gpu
def test_remat_save_equals_recompute_on_the_card(cuda):
    """remat="save" keeps the forward's xA, "recompute" recomputes it: the
    same deterministic kernels on the same inputs, so the output and both
    LoRA gradients are bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(13)
    x = _rnd(g, (2, 2, 256, 1024), torch.bfloat16)
    a0 = _rnd(g, (2, 1024, 16), torch.bfloat16, 1024 ** -0.5)
    b0 = _rnd(g, (2, 16, 768), torch.bfloat16)
    al = torch.tensor([2.0, 0.5], device=cuda)
    res = {}
    for remat in ("save", "recompute"):
        a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        n0 = _n("packed_matmul_bwd")
        y = ops.packed_lora_delta(x, a, b, al, remat=remat)
        (y.float() ** 2).sum().backward()
        assert _n("packed_matmul_bwd") > n0
        res[remat] = (y, a.grad, b.grad)
    for got, want in zip(res["save"], res["recompute"]):
        assert torch.equal(got, want)


DECODE_SHAPES = [  # (n, m, k, l, r), bf16
    (1, 1, 392, 80, 1),        # one row; rank 1: A read an element at a time; ragged strips
    (8, 1, 392, 80, 8),
    (16, 1, 392, 80, 16),      # 16 rows: the 16-row tile
    (4, 4, 392, 80, 128),      # 4 adapters x 4 rows; the widest rank
    (2, 8, 392, 80, 12),       # a rank off a multiple of 8
    (8, 1, 4104, 80, 16),      # K split over a cluster of 8, the last range short
    (16, 1, 18944, 512, 32),   # 16 rows, K staged in several chunks
    (8, 1, 3584, 3584, 16),    # qwen25-7b q, o
    (8, 1, 3584, 512, 16),     # k, v
    (8, 1, 3584, 18944, 16),   # gate, up
    (8, 1, 18944, 3584, 16),   # down
]


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,k,l,r", DECODE_SHAPES)
def test_decode_path_matches_plain(cuda, n, m, k, l, r):
    """bf16 decode rows take the weight-streaming kernel (csrc/decode.cuh):
    against the plain version with a scale and without, the same bits on a
    second call, and int8/nf4 ``torch.equal`` to the dense kernel on the
    dequantized W."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    dt = torch.bfloat16
    x, w = _rnd(gen, (n, m, k), dt), _rnd(gen, (k, l), dt, k ** -0.5)
    a, b = _rnd(gen, (n, k, r), dt, k ** -0.5), _rnd(gen, (n, r, l), dt)
    s = torch.linspace(0.5, 2.0, n, device=cuda)
    assert fused_matmul_path(x, w, r, a, b) == "decode"
    n0 = _n("fused_matmul")
    y = fused_matmul(x, w, a, b, s)
    assert _n("fused_matmul") == n0 + 1 and y.shape == (n, m, l) and y.is_contiguous()
    _close(y, fused_matmul_ref(x, w, a, b, s))
    assert torch.equal(y, fused_matmul(x, w, a, b, s))
    _close(fused_matmul(x, w, a, b), fused_matmul_ref(x, w, a, b))
    for mode in ("int8", "nf4"):
        q = quantize_weight(_rnd(gen, (k, l), torch.float32, k ** -0.5), mode)
        assert fused_matmul_q_path(x, q["codes"], q["scales"], r, a, b) == "decode"
        got = fused_matmul_q(x, q["codes"], q["scales"], a, b, s)
        assert torch.equal(got, fused_matmul(x, dequantize(q, dt), a, b, s))
        assert torch.equal(got, fused_matmul_q(x, q["codes"], q["scales"], a, b, s))
        _close(got, fused_matmul_q_ref(x, q["codes"], q["scales"], a, b, s))


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_ragged_ops_and_train_step_never_synchronise(cuda, impl):
    """Ragged ``packed_lora_delta``/``fused_lora_linear``, forward and
    backward, with ranks out of order and sorted, and one ``make_train_step``
    step of a reduced qwen25-7b, run under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host wait raises) once a
    first call has made their plans, vectors and index tensors; the checked
    call gives the first call's bits."""
    from repro_torch.configs import LoraConfig, get_config, reduced
    from repro_torch.core.adapter import pack_meta
    from repro_torch.models.model import init_model
    from repro_torch.train.data import packed_batch_iterator
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import make_train_step

    def sync_free(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    gen = torch.Generator(device=cuda).manual_seed(11)
    dt = torch.bfloat16
    w = _rnd(gen, (256, 96), dt, 256 ** -0.5)
    for ranks in ((32, 8, 16, 8), (8, 16, 16, 32)):
        x = _rnd(gen, (4, 2, 16, 256), dt)
        a0, b0 = _rnd(gen, (4, 256, 32), dt, 256 ** -0.5), _rnd(gen, (4, 32, 96), dt)
        al = torch.tensor([2.0, 0.5, 1.0, 1.5], device=cuda)

        def run():
            a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
            if impl == "auto":
                y = ops.packed_lora_delta(x, a, b, al, impl=impl, ranks=ranks)
            else:
                y = ops.fused_lora_linear(x, w, a, b, al, impl=impl, ranks=ranks)
            (y.float() ** 2).sum().backward()
            return y, a.grad, b.grad

        first = run()
        for got, want in zip(sync_free(run), first):
            assert torch.equal(got, want)
    cfg = reduced(get_config("qwen25-7b"))
    configs = [LoraConfig(rank=r, alpha=2.0 * r, batch_size=1) for r in (32, 8, 16, 8)]
    meta = pack_meta(configs)
    base, lora = init_model(0, cfg, meta, dtype=dt, device=cuda)
    batch = next(packed_batch_iterator(cfg, configs, seq=32, device=cuda))
    step = make_train_step(cfg, meta, step_budgets=(4, 4, 2, 4), impl=impl)
    opt = init_opt_state(lora)
    _, _, m1 = step(base, lora, opt, batch)
    _, _, m2 = sync_free(lambda: step(base, lora, opt, batch))
    assert torch.equal(m1["per_adapter_loss"], m2["per_adapter_loss"])


# (K, L) of the decode path's calls at rank r: xA (L = r) and (xA)B (K = r)
def _decode_kl(r):
    return [(r, r), (40, r), (3584, r), (r, 40), (r, 3584)]


@pytest.mark.gpu
@pytest.mark.parametrize("r", [8, 16, 64, 128])
@pytest.mark.parametrize("m", [1, 5, 8, 16])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_packed_matmul_decode_path_matches_plain(cuda, n, m, r):
    """bf16 calls of at most 16 rows per adapter take the streaming kernels
    of csrc/decode_rows.cuh: against the plain version with a scale and
    without, the same bits on a second call, one launch a call; (xA)B also
    at qwen25-7b's widest output."""
    g = torch.Generator(device=cuda).manual_seed(20 + 100 * n + 10 * m + r)
    shapes = _decode_kl(r) + ([(r, 18944)] if (n, m) == (8, 1) else [])
    for k, l in shapes:
        x, w = _rnd(g, (n, m, k), torch.bfloat16), _rnd(g, (n, k, l), torch.bfloat16, k ** -0.5)
        assert packed_matmul_path(x, w) == "decode", (k, l)
        for s in (torch.linspace(0.5, 2.0, n, device=cuda), None):
            n0 = _n("packed_matmul")
            got = packed_matmul(x, w, s)
            assert _n("packed_matmul") == n0 + 1
            _close(got, packed_matmul_ref(x, w, s))
            assert torch.equal(got, packed_matmul(x, w, s)), (k, l)


@pytest.mark.gpu
def test_decode_path_rows_do_not_depend_on_the_row_count(cuda):
    """A row's bits are the same whether its call has 1 row per adapter or
    16 (one summation order for every M): xA and (xA)B at qwen25-7b's k and
    gate widths."""
    g = torch.Generator(device=cuda).manual_seed(21)
    s = torch.linspace(0.5, 2.0, 8, device=cuda)
    for k, l in ((3584, 16), (18944, 16), (16, 512), (16, 18944)):
        x, w = _rnd(g, (8, 16, k), torch.bfloat16), _rnd(g, (8, k, l), torch.bfloat16, k ** -0.5)
        full = packed_matmul(x, w, s)
        for i in (0, 7, 15):
            assert torch.equal(full[:, i:i + 1], packed_matmul(x[:, i:i + 1].contiguous(), w, s))


@pytest.mark.gpu
def test_decode_path_is_taken_exactly_where_the_plan_says(cuda):
    """"decode" for bf16, at most 16 rows, x and w row-major, K and L
    multiples of 8, 16-byte aligned pointers, L or K at most 128; "fma" or
    "mma" for every call that misses one of them."""
    g = torch.Generator(device=cuda).manual_seed(22)
    bf = torch.bfloat16
    x, a = _rnd(g, (8, 16, 3584), bf), _rnd(g, (8, 3584, 16), bf)
    xa, b = _rnd(g, (8, 16, 16), bf), _rnd(g, (8, 16, 3584), bf)
    assert packed_matmul_path(x, a) == "decode"  # xA
    assert packed_matmul_path(xa, b) == "decode"  # (xA)B
    assert packed_matmul_path(x[:, :1].contiguous(), a) == "decode"  # one row
    assert packed_matmul_path(x.float(), a.float()) == "fma"  # f32
    assert packed_matmul_path(xa.float(), b.float()) == "fma"
    x17 = _rnd(g, (8, 17, 3584), bf)
    assert packed_matmul_path(x17, a) == "mma"  # 17 rows
    assert packed_matmul_path(_rnd(g, (8, 3584, 16), bf).transpose(1, 2), a) == "fma"  # x^T
    assert packed_matmul_path(xa, _rnd(g, (8, 3584, 16), bf).transpose(1, 2)) == "fma"  # w^T
    assert packed_matmul_path(_rnd(g, (8, 16, 3580), bf), _rnd(g, (8, 3580, 16), bf)) == "fma"  # K
    assert packed_matmul_path(x, _rnd(g, (8, 3584, 12), bf)) == "fma"  # L = 12
    assert packed_matmul_path(x, _rnd(g, (8, 3584, 136), bf)) == "fma"  # L and K > 128
    off = torch.empty(8 * 16 * 3584 + 1, dtype=bf, device=cuda)[1:].view(8, 16, 3584)
    assert packed_matmul_path(off, a) == "fma"  # x off 16 bytes


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["save", "recompute"])
@pytest.mark.parametrize("xdim", [3, 4])
def test_paired_delta_equals_two_calls(cuda, remat, xdim):
    """At decode rows the delta's two passes run as one call (the second a
    programmatic dependent launch): out and xa ``torch.equal`` to two
    ``packed_matmul`` calls, two launches counted, and the delta's output
    and LoRA gradients equal under remat "save" and "recompute"."""
    g = torch.Generator(device=cuda).manual_seed(23)
    n, r = 8, 16
    for d_in, d_out in ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)):
        x = _rnd(g, (n, 1, d_in) if xdim == 3 else (n, 1, 1, d_in), torch.bfloat16)
        a0 = _rnd(g, (n, d_in, r), torch.bfloat16, d_in ** -0.5)
        b0 = _rnd(g, (n, r, d_out), torch.bfloat16)
        s = torch.linspace(0.5, 2.0, n, device=cuda)
        x3 = x.reshape(n, -1, d_in)
        n0 = _n("packed_matmul")
        out, xa = packed_matmul_pair(x3, a0, b0, s)
        assert _n("packed_matmul") == n0 + 2
        want_xa = packed_matmul(x3, a0)
        assert torch.equal(xa, want_xa) and torch.equal(out, packed_matmul(want_xa, b0, s))
        a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        y = ops.packed_lora_delta(x, a, b, s, remat=remat)
        assert torch.equal(y.reshape(out.shape), out)
        (y.float() ** 2).sum().backward()
        a2, b2 = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        y2 = ops.packed_lora_delta(x, a2, b2, s, impl="plain")
        (y2.float() ** 2).sum().backward()
        _close(y, y2)
        _close(a.grad, a2.grad)
        _close(b.grad, b2.grad)
        other = {"save": "recompute", "recompute": "save"}[remat]
        a3, b3 = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        y3 = ops.packed_lora_delta(x, a3, b3, s, remat=other)
        (y3.float() ** 2).sum().backward()
        assert torch.equal(y, y3) and torch.equal(a.grad, a3.grad) and torch.equal(b.grad, b3.grad)


@pytest.mark.gpu
def test_nf4_dequantize_and_delta_never_synchronise(cuda):
    """``dequantize`` keeps the nf4 codebook on the card after its first
    call: ``lora_linear`` on an nf4 base under impl="auto" (``dequantize``,
    then the paired delta at decode rows), forward and backward, runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host wait raises) and
    gives the first call's bits."""
    from repro_torch.core.packed_lora import lora_linear

    g = torch.Generator(device=cuda).manual_seed(24)
    q = quantize_weight(_rnd(g, (3584, 512), torch.float32, 3584 ** -0.5), "nf4")
    x = _rnd(g, (8, 1, 3584), torch.bfloat16)
    a0, b0 = _rnd(g, (8, 3584, 16), torch.bfloat16, 3584 ** -0.5), _rnd(g, (8, 16, 512), torch.bfloat16)
    s = torch.linspace(0.5, 2.0, 8, device=cuda)

    def run():
        a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        y = lora_linear(x, {"w": q}, {"a": a, "b": b}, s, 8, kcfg=ops.KernelConfig(impl="auto"))
        (y.float() ** 2).sum().backward()
        return dequantize(q, torch.bfloat16), y, a.grad, b.grad

    first = run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for u, v in zip(got, first):
        assert torch.equal(u, v)


@pytest.mark.gpu
@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two CUDA devices")
def test_every_path_launches_on_every_device(cuda):
    """A kernel's function attributes (its shared memory, its cluster size)
    belong to the device they were set on: every path launches, and agrees
    with its plain version, on every card, the last card first."""
    bf = torch.bfloat16
    for d in reversed(range(torch.cuda.device_count())):
        dev = torch.device("cuda", d)
        with torch.cuda.device(dev):
            g = torch.Generator(device=dev).manual_seed(30 + d)
            s = torch.tensor([0.5, 2.0], device=dev)
            for m, path, fused_path in ((1, "decode", "decode"), (1024, "mma", "wgmma")):
                x, a = _rnd(g, (2, m, 3584), bf), _rnd(g, (2, 3584, 16), bf, 3584 ** -0.5)
                xa, b = _rnd(g, (2, m, 16), bf), _rnd(g, (2, 16, 512), bf)
                assert packed_matmul_path(x, a) == path and packed_matmul_path(xa, b) == path
                _close(packed_matmul(x, a), packed_matmul_ref(x, a))
                _close(packed_matmul(xa, b, s), packed_matmul_ref(xa, b, s))
                _close(packed_matmul_pair(x, a, b, s)[0],
                       packed_matmul_ref(packed_matmul_ref(x, a), b, s))
                gs = _rnd(g, (2, m, 512), bf)  # backward case 2 on b's transpose
                _close(packed_matmul(gs, b.transpose(1, 2), backward=True),
                       packed_matmul_ref(gs, b.transpose(1, 2)))
                w = _rnd(g, (3584, 512), bf, 3584 ** -0.5)
                assert fused_matmul_path(x, w, 16, a, b) == fused_path
                _close(fused_matmul(x, w, a, b, s), fused_matmul_ref(x, w, a, b, s))
                for mode in ("int8", "nf4"):
                    q = quantize_weight(_rnd(g, (3584, 512), torch.float32, 3584 ** -0.5), mode)
                    _close(fused_matmul_q(x, q["codes"], q["scales"], a, b, s),
                           fused_matmul_q_ref(x, q["codes"], q["scales"], a, b, s))


def _skinny_call(lhs, rhs, scale=None, backward=False):
    """One packed_matmul call that must take the f32skinny path: named so by
    the plan, counted once under its direction and "f32skinny"."""
    assert packed_matmul_path(lhs, rhs) == "f32skinny", (lhs.shape, rhs.shape, rhs.stride())
    want = dict(packed_matmul.launches)
    want["bwd" if backward else "fwd", "f32skinny"] += 1
    y = packed_matmul(lhs, rhs, scale, backward=backward)
    assert packed_matmul.launches == want
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("r", [8, 16])
def test_f32skinny_at_the_launcher_shapes(cuda, r):
    """The calls ``--impl auto`` makes of one rank segment of the launcher's
    pack (N = 1 x M = 1,024) at every projection of qwen25-7b: xA, (xA)B,
    case 2 on B's transposed view and case 4 on A's take the streaming FFMA
    kernels, agree with the plain version and give the same bits twice."""
    gen = torch.Generator(device=cuda).manual_seed(50 + r)
    n, m, f32 = 1, 1024, torch.float32
    s = torch.tensor([1.5], device=cuda)
    for d_in, d_out in TRAIN_PROJ:
        x, a = _rnd(gen, (n, m, d_in), f32), _rnd(gen, (n, d_in, r), f32, d_in ** -0.5)
        xa, b, gs = _rnd(gen, (n, m, r), f32), _rnd(gen, (n, r, d_out), f32), \
            _rnd(gen, (n, m, d_out), f32)
        for lhs, rhs, sc, bwd in ((x, a, None, False), (xa, b, s, False),
                                  (gs, b.transpose(1, 2), None, True),
                                  (xa, a.transpose(1, 2), None, True)):
            y = _skinny_call(lhs, rhs, sc, backward=bwd)
            _close(y, packed_matmul_ref(lhs, rhs, sc))
            assert torch.equal(y, packed_matmul(lhs, rhs, sc))


@pytest.mark.gpu
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("r", [8, 16, 24, 128])
def test_f32skinny_path_matches_plain(cuda, r, n, scaled):
    """f32 calls with more than 16 rows, w row-major or read transposed in
    place, at ragged shapes: M = 304 or 300 (off the 32- and 64-row tiles),
    K = 3,592 (off the 64-deep stage) into L = r (narrow: xA, case 2), and K
    = r into L = 3,592 (off the 64-column tile; short K: (xA)B, case 4)."""
    gen = torch.Generator(device=cuda).manual_seed(60 + r + n)
    d, f32 = 3592, torch.float32
    s = torch.linspace(0.5, 2.0, n, device=cuda) if scaled else None
    for m in (304, 300):
        for tw in (False, True):
            for k, l in ((d, r), (r, d)):
                x = _rnd(gen, (n, m, k), f32)
                w = (_rnd(gen, (n, l, k), f32, k ** -0.5).transpose(1, 2) if tw
                     else _rnd(gen, (n, k, l), f32, k ** -0.5))
                y = _skinny_call(x, w, s)
                assert y.shape == (n, m, l) and y.is_contiguous()
                _close(y, packed_matmul_ref(x, w, s))


@pytest.mark.gpu
def test_f32skinny_is_taken_exactly_where_the_plan_says(cuda):
    """"f32skinny" for f32 with more than 16 rows, x row-major, K and L
    multiples of 4, L or K at most 128, pointers on 16 bytes; "fma" for a
    call that misses one of them (decode rows, case 1's rows of the rank,
    x transposed, K = 3,590, both outer sizes above 128, x off 16 bytes)."""
    gen = torch.Generator(device=cuda).manual_seed(70)
    f32 = torch.float32
    x, a = _rnd(gen, (2, 64, 3584), f32), _rnd(gen, (2, 3584, 12), f32)
    assert packed_matmul_path(x, a) == "f32skinny"  # L = 12: width class 16
    assert packed_matmul_path(x[:, :17].contiguous(), a) == "f32skinny"  # 17 rows
    assert packed_matmul_path(x[:, :16].contiguous(), a) == "fma"  # 16 rows
    assert packed_matmul_path(_rnd(gen, (2, 64, 16), f32).transpose(1, 2), x) == "fma"  # case 1
    assert packed_matmul_path(_rnd(gen, (2, 3584, 64), f32).transpose(1, 2), a) == "fma"  # x^T
    assert packed_matmul_path(_rnd(gen, (2, 64, 3590), f32), _rnd(gen, (2, 3590, 16), f32)) \
        == "fma"  # K
    assert packed_matmul_path(_rnd(gen, (2, 64, 136), f32), _rnd(gen, (2, 136, 132), f32)) \
        == "fma"  # L and K above 128
    off = torch.empty(2 * 64 * 3584 + 1, dtype=f32, device=cuda)[1:].view(2, 64, 3584)
    assert packed_matmul_path(off, a) == "fma"  # x off 16 bytes
    _close(packed_matmul(off, a), packed_matmul_ref(off, a))


@pytest.mark.gpu
def test_f32skinny_is_deterministic_and_captures(cuda):
    """Gate/up's case 2 at the training shapes splits K over a cluster; its
    partial sums are added in rank order, so a call gives the same bits
    twice, as does the short-K class. Calls captured in a CUDA graph (the
    launcher's step) replay to the eager calls' bits."""
    gen = torch.Generator(device=cuda).manual_seed(71)
    f32 = torch.float32
    gs, b = _rnd(gen, (2, 1024, 18944), f32), _rnd(gen, (2, 16, 18944), f32)
    dxa, a = _rnd(gen, (2, 1024, 16), f32), _rnd(gen, (2, 3584, 16), f32)
    s = torch.tensor([0.5, 2.0], device=cuda)
    calls = ((gs, b.transpose(1, 2), None), (dxa, a.transpose(1, 2), None), (dxa, b, s))
    eager = []
    for lhs, rhs, sc in calls:
        y = _skinny_call(lhs, rhs, sc)
        assert torch.equal(y, packed_matmul(lhs, rhs, sc))
        eager.append(y)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for lhs, rhs, sc in calls:
            packed_matmul(lhs, rhs, sc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [packed_matmul(lhs, rhs, sc) for lhs, rhs, sc in calls]
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)


# sha256 of the f32 fused rows' bits at the launcher's shapes (r = 16), from
# the tree before the f32skinny path: #2/#3's f32 path (its xA pass on
# tile.cuh's FMA kernel) must not move
FFMA_F32_BITS = {'3584x3584:fwd': 'c408bdbc611e9ac0d45ac1a4bc81ddfe002f8856823ff1b6c470a1ccde6fb633', '3584x3584:dx': 'cf60b5d6958017ff9fdf5a5aa9a2a918dc0c9001e67925b7304c900ed75dd2df', '3584x512:fwd': '8cc44e171ecc240f79aa6505371e3e7c53d97cb57c293e5e15453af7973bde70', '3584x512:dx': '657a27a3b7e8b7242f33421bd0f636e59d99e5c31a3243c1465f787dabb87552', '3584x512:int8': 'e39b4f76ce0b82e30d768dd750cea002882e2a30fc48c363696a483e2b10ca32', '3584x512:nf4': 'de7719ec293a7281251ec3615081a446e68c986c483c4e2ce6aa64ce329aae3b', '3584x18944:fwd': 'de6662f206f4e88488370819c7d9ecfdfdf524f8d8ec3ea16d2771ce0b5b926c', '3584x18944:dx': '8c248713ab0ea27ec59d152f77c4b3c0e626912721a731bb94501a8350679007', '18944x3584:fwd': '2400eecb2281760fa3a8b94eb9cee271552119105429020a8066c0445949febb', '18944x3584:dx': 'c7ae7c858e810c4b01b38f6c13f0052cd047af265553a821adc9609483835265'}


@pytest.mark.gpu
def test_ffma_f32_rows_keep_their_bits(cuda):
    """#2's f32 forward and dx and #3's int8/nf4 on an f32 x, at the
    launcher's shapes (N = 1 x M = 1,024, r = 16), on inputs drawn on the
    CPU from a seed: the same bits as before the f32skinny path."""
    import hashlib

    gen = torch.Generator().manual_seed(80)

    def rnd(shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(cuda)

    bits = {}
    r, s = 16, torch.tensor([1.5], device=cuda)
    for d_in, d_out in TRAIN_PROJ:
        x, w = rnd((1, 1024, d_in)), rnd((d_in, d_out), d_in ** -0.5)
        a, b, g = rnd((1, d_in, r), d_in ** -0.5), rnd((1, r, d_out)), rnd((1, 1024, d_out))
        ys = {"fwd": fused_matmul(x, w, a, b, s),
              "dx": fused_matmul(g, w.t(), b.transpose(1, 2).contiguous(),
                                 a.transpose(1, 2).contiguous(), s, backward=True)}
        if (d_in, d_out) == (3584, 512):
            for mode in ("int8", "nf4"):
                q = quantize_weight(w, mode)
                ys[mode] = fused_matmul_q(x, q["codes"], q["scales"], a, b, s)
        for name, y in ys.items():
            bits[f"{d_in}x{d_out}:{name}"] = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
    print(bits)
    assert bits == FFMA_F32_BITS


# --- the K-split override (``blocks``) the autotuner sweeps ----------------


def _parent_splits(path, rows, k, l, r):
    """The K ranges the plans chose before a caller could ask for another
    count (``plan_wgmma`` and ``plan_ffma`` of ``csrc/fused.cuh`` /
    ``ffma.cuh``, reimplemented): what ``blocks=None`` must still give."""
    import math

    if path == "wgmma":
        rp = 16 if r <= 16 else 32 if r <= 32 else 64 if r <= 64 else 128
        bn = 256 if rp <= 16 else 128
        tiles = -(-rows // 128) * -(-l // bn)
        ksteps = -(-k // 64)
        s = 1 if tiles >= 132 else 132 // tiles
        s = max(1, min(s, 32, ksteps // 4))
    else:
        tiles = -(-rows // 128) * -(-l // 128)
        ksteps = -(-k // 32)
        s_per_k = 2.0 * 128 * 128 / (0.6 * 67e12 / 132)

        def t(s):
            base = math.ceil(tiles * s / 132) * s_per_k * math.ceil(k / s)
            return base if s == 1 else base + 8.0 * s * rows * l / 3.35e12 + 1e-5

        s = 1
        for c in range(2, 5):
            if ksteps >= 4 * c and t(c) < t(s):
                s = c
    steps = -(-ksteps // s)
    return -(-ksteps // steps)


def _train_operands(gen, dt, n, m, d_in, d_out, r, cuda):
    w = _rnd(gen, (d_in, d_out), dt, d_in ** -0.5)
    x, a, b = _rnd(gen, (n, m, d_in), dt), _rnd(gen, (n, d_in, r), dt, d_in ** -0.5), \
        _rnd(gen, (n, r, d_out), dt)
    g = _rnd(gen, (n, m, d_out), dt)
    s = torch.linspace(0.5, 2.0, n, device=cuda)
    return ((x, w, a, b, s), False), ((g, w.t(), b.transpose(1, 2).contiguous(),
                                       a.transpose(1, 2).contiguous(), s), True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out", TRAIN_PROJ)
def test_every_k_split_candidate_matches_plain_and_keeps_its_path(cuda, dtype, d_in, d_out):
    """At the training shapes (N = 2 x M = 1,024, r = 16) every K-split
    count the autotuner asks of the "wgmma" (bf16) and "ffma" (f32) paths,
    forward and dx, keeps the path, takes the count the plan clamps it to,
    agrees with the plain version and counts one launch on its path; with
    ``blocks=None`` the plan takes the count it took before the override
    existed (bit for bit the same call)."""
    from repro_torch.kernels.autotune import SPLIT_GRID
    from repro_torch.kernels.fused import fused_matmul_splits

    gen = torch.Generator(device=cuda).manual_seed(90)
    dt, path = DTYPES[dtype], ("ffma" if dtype == "float32" else "wgmma")
    n, m, r = 2, 1024, 16
    for args, bwd in _train_operands(gen, dt, n, m, d_in, d_out, r, cuda):
        x, w, a, b, s = args
        k, l = x.shape[2], w.shape[1]
        want = fused_matmul_ref(*args)
        own = fused_matmul_splits(x, w, r, a, b)
        assert own == _parent_splits(path, n * m, k, l, r)
        ksteps = -(-k // (32 if path == "ffma" else 64))
        for req in SPLIT_GRID[path]:
            got_s = fused_matmul_splits(x, w, r, a, b, blocks=[req])
            assert got_s == max(1, min(req, 4 if path == "ffma" else 32, ksteps // 4))
            assert fused_matmul_path(x, w, r, a, b) == path
            before = dict(fused_matmul.launches)
            y = fused_matmul(*args, backward=bwd, blocks=[req])
            before["bwd" if bwd else "fwd", path] += 1
            assert fused_matmul.launches == before
            _close(y, want)
            if got_s == own:
                assert torch.equal(y, fused_matmul(*args, backward=bwd))
        assert torch.equal(fused_matmul(*args, backward=bwd, blocks=None),
                           fused_matmul(*args, backward=bwd, blocks=[own]))


@pytest.mark.gpu
def test_a_split_beyond_the_paths_limit_is_clamped(cuda):
    """A request above the path's limit takes the limit the plan keeps (at
    most 32 ranges on "wgmma", 4 on "ffma", and at least 4 K steps each):
    its count, its workspace and its output are the clamped request's."""
    from repro_torch.kernels import fused as fused_module
    from repro_torch.kernels.fused import fused_matmul_splits

    gen = torch.Generator(device=cuda).manual_seed(91)
    for dt, k, req, clamped in ((torch.bfloat16, 3584, 64, 14), (torch.bfloat16, 256, 8, 1),
                                (torch.float32, 3584, 9, 4), (torch.float32, 256, 4, 2)):
        n, m, l, r = 2, 512, 512, 16
        x, w = _rnd(gen, (n, m, k), dt), _rnd(gen, (k, l), dt, k ** -0.5)
        a, b = _rnd(gen, (n, k, r), dt, k ** -0.5), _rnd(gen, (n, r, l), dt)
        s = torch.tensor([0.5, 2.0], device=cuda)
        assert fused_matmul_splits(x, w, r, a, b, blocks=[req]) == clamped
        code = 0 if dt == torch.float32 else 1
        assert fused_module._plan("fused", n, m, k, l, r, code, 1, 1, 0, req) == \
            fused_module._plan("fused", n, m, k, l, r, code, 1, 1, 0, clamped)
        y = fused_matmul(x, w, a, b, s, blocks=[req])
        assert torch.equal(y, fused_matmul(x, w, a, b, s, blocks=[clamped]))
        _close(y, fused_matmul_ref(x, w, a, b, s))
    with pytest.raises(ValueError, match="k_splits"):
        fused_matmul(x, w, a, b, s, blocks=[0])


@pytest.mark.gpu
def test_the_captured_steps_key_separates_two_splits(cuda):
    """``train_pack(blocks=)`` is part of the step's key, and so of its
    graph's: another split captures anew, the same split hits; the two
    splits' runs agree (one f32 function, two orders of sums)."""
    from repro_torch.cluster import DevicePool, SliceExecutor
    from repro_torch.configs import LoraConfig, get_config, reduced
    from repro_torch.models.model import init_model

    cfg = reduced(get_config("qwen25-7b"))
    base, _ = init_model(0, cfg, None, device=cuda)  # f32: the "ffma" path, K in 8 steps
    pack = [LoraConfig(rank=8, alpha=16.0, learning_rate=1e-3, batch_size=2, seq_len=16),
            LoraConfig(rank=16, alpha=4.0, learning_rate=5e-4, batch_size=2, seq_len=16)]
    ex = SliceExecutor()
    slice_ = DevicePool([cuda]).acquire(1)

    def run(blocks):
        res = ex.train_pack(cfg, pack, n_steps=2, seq=16, base=base, slice_=slice_,
                            impl="fused", blocks=blocks)
        return res.losses

    one = run((1,))
    assert (ex.n_builds, ex.n_hits) == (1, 0)
    two = run((2,))
    assert (ex.n_builds, ex.n_hits, len(ex.captures)) == (2, 0, 2)
    assert np.array_equal(run((2,)), two) and (ex.n_builds, ex.n_hits) == (2, 1)
    np.testing.assert_allclose(two, one, rtol=1e-5)


# one layer's projections (d_in, d_out) of the two dense families besides
# qwen25-7b: starcoder2-7b (d 4,608, k/v 512, d_ff 18,432) and gemma3-1b
# (d 1,152, q 1,024, k/v 256, d_ff 6,912)
FAMILY_PROJ = {
    "starcoder2-7b": [(4608, 4608), (4608, 512), (4608, 18432), (18432, 4608)],
    "gemma3-1b": [(1152, 1024), (1152, 256), (1024, 1152), (1152, 6912), (6912, 1152)],
    # minicpm3-4b's adapted projections: q_a, kv_a (the 256-wide latent and
    # the 32-wide rope part), o, gate/up, down
    "minicpm3-4b": [(2560, 768), (2560, 288), (2560, 2560), (2560, 6400), (6400, 2560)],
    # mamba2-370m's adapted projections: zx (d 1,024 -> z and x, 2 x 2,048)
    # and out (d_inner 2,048 -> 1,024)
    "mamba2-370m": [(1024, 4096), (2048, 1024)],
    # jamba-v0.1-52b's: the attention layer's q/o (4,096 -> 4,096) and k/v
    # (4,096 -> 1,024), an SSD layer's zx (4,096 -> 16,384) and out (8,192
    # -> 4,096)
    "jamba-v0.1-52b": [(4096, 4096), (4096, 1024), (4096, 16384), (8192, 4096)],
    # whisper-tiny's: q/v (and the cross q) 384 -> 384, gate/up 384 ->
    # 1,536, down; internvl2-1b's: q/o 896 -> 896, k/v 896 -> 128, gate/up
    # 896 -> 4,864, down
    "whisper-tiny": [(384, 384), (384, 1536), (1536, 384)],
    "internvl2-1b": [(896, 896), (896, 128), (896, 4864), (4864, 896)],
}


def _count(kernel, direction, path):
    return kernel.launches[direction, path]


@pytest.mark.gpu
@pytest.mark.parametrize("d_in,d_out", [p for ps in FAMILY_PROJ.values() for p in ps])
def test_family_training_shapes_match_plain_on_their_paths(cuda, d_in, d_out):
    """bf16 at each new family's training shapes (N = 2 x M = 1,024, r =
    16): #1's xA, xAB and backward cases 2 and 4 on "mma", #2's forward and
    dx (W^T in place) on "wgmma", each launched once on that path and
    within the tolerance of its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(50)
    n, m, r, dt = 2, 1024, 16, torch.bfloat16
    s = torch.tensor([0.5, 2.0], device=cuda)
    x, w = _rnd(gen, (n, m, d_in), dt), _rnd(gen, (d_in, d_out), dt, d_in ** -0.5)
    a, b = _rnd(gen, (n, d_in, r), dt, d_in ** -0.5), _rnd(gen, (n, r, d_out), dt)
    g = _rnd(gen, (n, m, d_out), dt)
    xa = _rnd(gen, (n, m, r), dt)
    for args, bwd in (((x, a), False), ((xa, b, s), False),
                      ((g, b.transpose(1, 2)), True), ((xa, a.transpose(1, 2)), True)):
        assert packed_matmul_path(args[0], args[1]) == "mma"
        n0 = _count(packed_matmul, "bwd" if bwd else "fwd", "mma")
        got = packed_matmul(*args, backward=True) if bwd else packed_matmul(*args)
        assert _count(packed_matmul, "bwd" if bwd else "fwd", "mma") == n0 + 1
        _close(got, packed_matmul_ref(*args))
    assert fused_matmul_path(x, w, r, a, b) == "wgmma"
    n0 = _count(fused_matmul, "fwd", "wgmma")
    _close(fused_matmul(x, w, a, b, s), fused_matmul_ref(x, w, a, b, s))
    assert _count(fused_matmul, "fwd", "wgmma") == n0 + 1
    bt, at = b.transpose(1, 2).contiguous(), a.transpose(1, 2).contiguous()
    assert fused_matmul_path(g, w.t(), r, bt, at) == "wgmma"
    n0 = _count(fused_matmul, "bwd", "wgmma")
    _close(fused_matmul(g, w.t(), bt, at, s, backward=True), fused_matmul_ref(g, w.t(), bt, at, s))
    assert _count(fused_matmul, "bwd", "wgmma") == n0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("d_in,d_out", FAMILY_PROJ["whisper-tiny"])
def test_whisper_encoder_rows_match_plain_on_their_planned_paths(cuda, d_in, d_out):
    """bf16 at whisper-tiny's encoder rows (1,500 frames an adapter, r =
    16): a pack of 2 (1,500 % 64 != 0: row tiles per adapter) and one
    adapter alone plan #2's forward and dx on "wgmma"; #1's xA, xAB and
    cases 2 and 4 on "mma" either way; each launched once on its path and
    within the tolerance of its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(53)
    m, r, dt = 1500, 16, torch.bfloat16
    w = _rnd(gen, (d_in, d_out), dt, d_in ** -0.5)
    for n, fused_path in ((2, "wgmma"), (1, "wgmma")):
        s = torch.linspace(0.5, 2.0, n, device=cuda)
        x, g = _rnd(gen, (n, m, d_in), dt), _rnd(gen, (n, m, d_out), dt)
        a, b = _rnd(gen, (n, d_in, r), dt, d_in ** -0.5), _rnd(gen, (n, r, d_out), dt)
        xa = _rnd(gen, (n, m, r), dt)
        for args, bwd in (((x, a), False), ((xa, b, s), False),
                          ((g, b.transpose(1, 2)), True), ((xa, a.transpose(1, 2)), True)):
            assert packed_matmul_path(args[0], args[1]) == "mma"
            n0 = _count(packed_matmul, "bwd" if bwd else "fwd", "mma")
            got = packed_matmul(*args, backward=True) if bwd else packed_matmul(*args)
            assert _count(packed_matmul, "bwd" if bwd else "fwd", "mma") == n0 + 1
            _close(got, packed_matmul_ref(*args))
        assert fused_matmul_path(x, w, r, a, b) == fused_path
        n0 = _count(fused_matmul, "fwd", fused_path)
        _close(fused_matmul(x, w, a, b, s), fused_matmul_ref(x, w, a, b, s))
        assert _count(fused_matmul, "fwd", fused_path) == n0 + 1
        bt, at = b.transpose(1, 2).contiguous(), a.transpose(1, 2).contiguous()
        assert fused_matmul_path(g, w.t(), r, bt, at) == fused_path
        n0 = _count(fused_matmul, "bwd", fused_path)
        _close(fused_matmul(g, w.t(), bt, at, s, backward=True),
               fused_matmul_ref(g, w.t(), bt, at, s))
        assert _count(fused_matmul, "bwd", fused_path) == n0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("d_in,d_out", FAMILY_PROJ["mamba2-370m"])
def test_mamba2_decode_rows_match_plain_on_the_decode_path(cuda, d_in, d_out):
    """bf16 decode rows at mamba2-370m's widths (8 rows, r = 16; zx 1,024
    -> 4,096, out 2,048 -> 1,024): #2 and both passes of #1 on "decode",
    each launched once there, the pair ``torch.equal`` to its two calls."""
    gen = torch.Generator(device=cuda).manual_seed(52)
    n, m, r, dt = 8, 1, 16, torch.bfloat16
    s = torch.linspace(0.5, 2.0, n, device=cuda)
    x, w = _rnd(gen, (n, m, d_in), dt), _rnd(gen, (d_in, d_out), dt, d_in ** -0.5)
    a, b = _rnd(gen, (n, d_in, r), dt, d_in ** -0.5), _rnd(gen, (n, r, d_out), dt)
    assert fused_matmul_path(x, w, r, a, b) == "decode"
    n0 = _count(fused_matmul, "fwd", "decode")
    _close(fused_matmul(x, w, a, b, s), fused_matmul_ref(x, w, a, b, s))
    assert _count(fused_matmul, "fwd", "decode") == n0 + 1
    assert packed_matmul_path(x, a) == "decode"
    n0 = _count(packed_matmul, "fwd", "decode")
    xa = packed_matmul(x, a)
    _close(xa, packed_matmul_ref(x, a))
    assert packed_matmul_path(xa, b) == "decode"
    _close(packed_matmul(xa, b, s), packed_matmul_ref(xa, b, s))
    assert _count(packed_matmul, "fwd", "decode") == n0 + 2
    y, xa2 = packed_matmul_pair(x, a, b, s)
    assert torch.equal(xa2, xa) and torch.equal(y, packed_matmul(xa, b, s))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [256, 600])
def test_ssd_scan_on_the_card_matches_the_cpu_scan_and_captures(cuda, s):
    """mamba2-370m's SSD scan (32 heads of 64, d_state 128, chunks of 256)
    in f32 on the card against the same scan on the CPU (600 tokens: two
    chunks and a padded third), y and the final state within 5e-5 of their
    largest value; then captured in a CUDA graph (no host sync in the
    scan), whose replay on new inputs equals an eager call bit for bit."""
    from repro_torch.models.layers.ssm import _ssd_scan

    gen = torch.Generator().manual_seed(53)
    nb, h, p, n = 2, 32, 64, 128
    xs = torch.randn((nb, s, h, p), generator=gen)
    b = 0.5 * torch.randn((nb, s, n), generator=gen)
    c = 0.5 * torch.randn((nb, s, n), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((nb, s, h), generator=gen) - 2.0)
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    state0 = 0.1 * torch.randn((nb, h, p, n), generator=gen)
    want_y, want_s = _ssd_scan(xs, b, c, dt, a_log, 256, state0=state0)
    dev = [t.to(cuda) for t in (xs, b, c, dt, a_log, state0)]
    got_y, got_s = _ssd_scan(*dev[:5], 256, state0=dev[5])
    torch.cuda.synchronize()
    _close(got_y.cpu(), want_y)
    _close(got_s.cpu(), want_s)
    static = [t.clone() for t in dev]
    _ssd_scan(*static[:5], 256, state0=static[5])  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap_y, cap_s = _ssd_scan(*static[:5], 256, state0=static[5])
    for dst, src in zip(static, dev):
        dst.copy_(src * 0.5 if dst is static[0] else src)
    graph.replay()
    eager_y, eager_s = _ssd_scan(dev[0] * 0.5, *dev[1:5], 256, state0=dev[5])
    torch.cuda.synchronize()
    assert torch.equal(cap_y, eager_y) and torch.equal(cap_s, eager_s)


@pytest.mark.gpu
@pytest.mark.parametrize("d_in,d_out", FAMILY_PROJ["gemma3-1b"])
def test_gemma3_decode_rows_match_plain_on_the_decode_path(cuda, d_in, d_out):
    """bf16 decode rows at gemma3-1b's widths (8 rows, r = 16; the k/v
    output 256 wide, d 1,152): #2 and both passes of #1 on "decode", the
    pair ``torch.equal`` to its two calls."""
    gen = torch.Generator(device=cuda).manual_seed(51)
    n, m, r, dt = 8, 1, 16, torch.bfloat16
    s = torch.linspace(0.5, 2.0, n, device=cuda)
    x, w = _rnd(gen, (n, m, d_in), dt), _rnd(gen, (d_in, d_out), dt, d_in ** -0.5)
    a, b = _rnd(gen, (n, d_in, r), dt, d_in ** -0.5), _rnd(gen, (n, r, d_out), dt)
    assert fused_matmul_path(x, w, r, a, b) == "decode"
    n0 = _count(fused_matmul, "fwd", "decode")
    _close(fused_matmul(x, w, a, b, s), fused_matmul_ref(x, w, a, b, s))
    assert _count(fused_matmul, "fwd", "decode") == n0 + 1
    assert packed_matmul_path(x, a) == "decode"
    xa = packed_matmul(x, a)
    _close(xa, packed_matmul_ref(x, a))
    assert packed_matmul_path(xa, b) == "decode"
    _close(packed_matmul(xa, b, s), packed_matmul_ref(xa, b, s))
    y, xa2 = packed_matmul_pair(x, a, b, s)
    assert torch.equal(xa2, xa) and torch.equal(y, packed_matmul(xa, b, s))


@pytest.mark.gpu
@pytest.mark.parametrize("r", [8, 16])
def test_kv_a_width_288_matches_plain_on_its_paths(cuda, r):
    """minicpm3-4b's kv_a, K = 2,560 -> L = 288, the first main-path width
    that is not a multiple of 64 (the wgmma kernel's K step): at the
    training shapes (N = 2 x M = 1,024) #1's xA and (xA)B and all four
    backward cases on "mma" (case 2 contracts over K = 288), #2's forward
    (a 256-wide column tile and a 32-wide one) and its dx (a K of 288) on
    "wgmma"; at 8 decode rows #2 and both passes of #1 on "decode", the
    pair ``torch.equal`` to its two calls. Each launched once on its path,
    within the tolerance of its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(70 + r)
    d, l, dt = 2560, 288, torch.bfloat16
    n, m = 2, 1024
    s = torch.tensor([0.5, 2.0], device=cuda)
    x, w = _rnd(gen, (n, m, d), dt), _rnd(gen, (d, l), dt, d ** -0.5)
    a, b = _rnd(gen, (n, d, r), dt, d ** -0.5), _rnd(gen, (n, r, l), dt)
    g, xa = _rnd(gen, (n, m, l), dt), _rnd(gen, (n, m, r), dt)
    for args, bwd in (((x, a), False), ((xa, b, s), False),
                      ((g, b.transpose(1, 2)), True), ((xa, a.transpose(1, 2)), True)):
        assert packed_matmul_path(args[0], args[1]) == "mma"
        n0 = _count(packed_matmul, "bwd" if bwd else "fwd", "mma")
        got = packed_matmul(*args, backward=True) if bwd else packed_matmul(*args)
        assert _count(packed_matmul, "bwd" if bwd else "fwd", "mma") == n0 + 1
        _close(got, packed_matmul_ref(*args))
    for lhs, rhs in ((xa.transpose(1, 2), g), (x.transpose(1, 2), xa)):  # cases 1 (dB), 3 (dA)
        _close(packed_matmul(lhs, rhs, backward=True), packed_matmul_ref(lhs, rhs))
    assert fused_matmul_path(x, w, r, a, b) == "wgmma"
    n0 = _count(fused_matmul, "fwd", "wgmma")
    _close(fused_matmul(x, w, a, b, s), fused_matmul_ref(x, w, a, b, s))
    assert _count(fused_matmul, "fwd", "wgmma") == n0 + 1
    bt, at = b.transpose(1, 2).contiguous(), a.transpose(1, 2).contiguous()
    assert fused_matmul_path(g, w.t(), r, bt, at) == "wgmma"
    n0 = _count(fused_matmul, "bwd", "wgmma")
    _close(fused_matmul(g, w.t(), bt, at, s, backward=True), fused_matmul_ref(g, w.t(), bt, at, s))
    assert _count(fused_matmul, "bwd", "wgmma") == n0 + 1
    n, m = 8, 1
    s = torch.linspace(0.5, 2.0, n, device=cuda)
    x = _rnd(gen, (n, m, d), dt)
    a, b = _rnd(gen, (n, d, r), dt, d ** -0.5), _rnd(gen, (n, r, l), dt)
    assert fused_matmul_path(x, w, r, a, b) == "decode"
    n0 = _count(fused_matmul, "fwd", "decode")
    _close(fused_matmul(x, w, a, b, s), fused_matmul_ref(x, w, a, b, s))
    assert _count(fused_matmul, "fwd", "decode") == n0 + 1
    assert packed_matmul_path(x, a) == "decode"
    xa = packed_matmul(x, a)
    _close(xa, packed_matmul_ref(x, a))
    assert packed_matmul_path(xa, b) == "decode"
    _close(packed_matmul(xa, b, s), packed_matmul_ref(xa, b, s))
    y, xa2 = packed_matmul_pair(x, a, b, s)
    assert torch.equal(xa2, xa) and torch.equal(y, packed_matmul(xa, b, s))


# one layer's projections (d_in, d_out) of command-r-35b (d 8,192, k/v 1,024,
# d_ff 22,528), which the card holds only on a quantized base
CR_PROJ = [(8192, 8192), (8192, 1024), (8192, 22528), (22528, 8192)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_command_r_streamed_init_equals_dense_then_quantize(cuda, mode):
    """``init_model(..., quant=mode)`` at command-r-35b's full width cut to
    2 layers, bf16, on the card: ``torch.equal`` leaf by leaf to
    ``quantize_base_params`` of the dense init (the dense base of 40 layers
    does not fit beside it)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant import quantize_base_params
    from repro_torch.models.model import init_model
    from repro_torch.tree import tree_leaves

    cfg = get_config("command-r-35b").replace(n_layers=2)
    got, _ = init_model(0, cfg, None, torch.bfloat16, cuda, quant=mode)
    dense, _ = init_model(0, cfg, None, torch.bfloat16, cuda)
    want = quantize_base_params(dense, mode)
    del dense
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b) == 18
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _quantized(gen, d_in, d_out, mode):
    q = quantize_weight(_rnd(gen, (d_in, d_out), torch.float32, d_in ** -0.5), mode)
    return q["codes"], q["scales"]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "nf4"])
@pytest.mark.parametrize("d_in,d_out", CR_PROJ)
def test_command_r_decode_rows_match_plain_on_the_decode_path(cuda, mode, d_in, d_out):
    """#3 at 8 bf16 decode rows (r = 16) at command-r-35b's widths (K and L
    up to 22,528; the nf4 block 64): on "decode", launched once there,
    within the tolerance of its plain version and ``torch.equal`` to the
    dense kernel on the dequantized W."""
    gen = torch.Generator(device=cuda).manual_seed(60)
    n, m, r, dt = 8, 1, 16, torch.bfloat16
    s = torch.linspace(0.5, 2.0, n, device=cuda)
    codes, scales = _quantized(gen, d_in, d_out, mode)
    x = _rnd(gen, (n, m, d_in), dt)
    a, b = _rnd(gen, (n, d_in, r), dt, d_in ** -0.5), _rnd(gen, (n, r, d_out), dt)
    assert fused_matmul_q_path(x, codes, scales, r, a, b) == "decode"
    n0 = _count(fused_matmul_q, "fwd", "decode")
    got = fused_matmul_q(x, codes, scales, a, b, s)
    assert _count(fused_matmul_q, "fwd", "decode") == n0 + 1
    _close(got, fused_matmul_q_ref(x, codes, scales, a, b, s))
    w = dequantize({"codes": codes, "scales": scales}, dt)
    assert torch.equal(got, fused_matmul(x, w, a, b, s))


@pytest.mark.gpu
@pytest.mark.parametrize("d_in,d_out", CR_PROJ)
def test_command_r_training_rows_match_plain_on_their_paths(cuda, d_in, d_out):
    """#3 at command-r-35b's training widths: int8 codes under a bf16 x (N =
    2 x M = 1,024, r = 16) on "wgmma", and nf4 codes under an f32 x at the
    launcher's segment (N = 1 x M = 512, r = 8) on "ffma"; each launched
    once on its path, within the tolerance of its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(61)
    for mode, dt, n, m, r, path in (("int8", torch.bfloat16, 2, 1024, 16, "wgmma"),
                                    ("nf4", torch.float32, 1, 512, 8, "ffma")):
        s = torch.linspace(0.5, 2.0, n, device=cuda)
        codes, scales = _quantized(gen, d_in, d_out, mode)
        x = _rnd(gen, (n, m, d_in), dt)
        a, b = _rnd(gen, (n, d_in, r), dt, d_in ** -0.5), _rnd(gen, (n, r, d_out), dt)
        assert fused_matmul_q_path(x, codes, scales, r, a, b) == path
        n0 = _count(fused_matmul_q, "fwd", path)
        got = fused_matmul_q(x, codes, scales, a, b, s)
        assert _count(fused_matmul_q, "fwd", path) == n0 + 1
        _close(got, fused_matmul_q_ref(x, codes, scales, a, b, s))


# a 2-layer model's last-position logits in bf16, relative to max |logit|:
# a summation order that differs in one projection moves its bf16 output
# by an ulp, which the layers after it carry (the smoke's LOGIT_TOL)
LOGIT_TOL = 5e-2
# the kernels' paths a chunked prefill takes, by impl: "mma" / "wgmma" at
# chunk rows, "decode" at a tail of at most 16
CHUNK_PATHS = {"auto": ("packed_matmul", ("mma", "decode")),
               "fused": ("fused_matmul", ("wgmma", "decode"))}


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_chunked_prefill_on_the_card(cuda, impl):
    """Reduced qwen25-7b in bf16: ``prefill_chunked`` in chunks of 64 over
    prompts of 104 tokens (a ragged tail of 40) and 137 (a tail of 9, the
    decode kernels' rows) holds the one-shot ``prefill``'s last-position
    logits within LOGIT_TOL of max |logit|, and the plain path's on the same
    chunks; its projections launch the kernels on "mma" / "wgmma" and on
    "decode"."""
    from repro_torch.configs import LoraConfig, get_config, reduced
    from repro_torch.core.adapter import pack_meta
    from repro_torch.models.model import init_model, prefill
    from repro_torch.serve.decode import prefill_chunked
    from repro_torch.tree import tree_map

    cfg = reduced(get_config("qwen25-7b"))
    meta = pack_meta([LoraConfig(rank=16, alpha=16.0)])
    base, lora = init_model(0, cfg, meta, torch.bfloat16, cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    lora = tree_map(lambda t: t + _rnd(gen, t.shape, t.dtype, 0.02), lora)
    scales = meta.scales(cuda)
    kcfg = ops.KernelConfig(impl=impl, ranks=meta.ranks)
    plain = ops.KernelConfig(impl={"auto": "plain", "fused": "fused_plain"}[impl],
                             ranks=meta.ranks)
    kernel, paths = CHUNK_PATHS[impl]
    for s in (104, 137):
        toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=cuda)
        with torch.no_grad():
            want, _ = prefill(base, lora, scales, {"tokens": toks}, cfg, kcfg=kcfg)
            launches.zero()
            got, _ = prefill_chunked(base, lora, scales, toks, cfg, 64, kcfg=kcfg)
            torch.cuda.synchronize()
            by_path = launches.read_paths()[kernel]
            ref, _ = prefill_chunked(base, lora, scales, toks, cfg, 64, kcfg=plain)
        top = want.float().abs().max()
        assert torch.isfinite(got.float()).all()
        assert (got.float() - want.float()).abs().max() <= LOGIT_TOL * top
        assert (got.float() - ref.float()).abs().max() <= LOGIT_TOL * ref.float().abs().max()
        tail = "decode" if s % 64 <= 16 else paths[0]
        assert by_path.get(paths[0], 0) > 0 and by_path.get(tail, 0) > 0, by_path


@pytest.mark.gpu
def test_sample_tokens_on_the_card(cuda):
    """``serve.sample_tokens`` on CUDA logits at qwen25-7b's vocabulary:
    greedy rows are the argmax bit for bit beside sampled ones, one seed
    repeats its draws, and no draw leaves its row's top-k set (ties kept)."""
    from repro_torch.serve import sample_tokens

    g = torch.Generator(device=cuda).manual_seed(0)
    rows, v = 8, 152_064
    lg = _rnd(g, (rows, v), torch.bfloat16, 4.0)
    lg[3, :50] = lg[3].max()  # a tie at the threshold wider than k
    temp = torch.tensor([0.0, 0.8, 0.0, 1.0, 0.5, 0.0, 2.0, 0.8], device=cuda)
    topk = torch.tensor([0, 50, 0, 20, 1, 50, 0, 50], dtype=torch.int32, device=cuda)

    def draw(seed):
        return sample_tokens(lg, temp, topk, torch.Generator(device=cuda).manual_seed(seed))

    a = draw(5)
    assert a.device.type == "cuda" and a.dtype == torch.int32
    argmax = torch.argmax(lg.float(), dim=-1).to(torch.int32)
    greedy = temp == 0
    assert torch.equal(a[greedy], argmax[greedy]) and int(a[4]) == int(argmax[4])
    assert torch.equal(a, draw(5))
    draws = torch.stack([draw(s) for s in range(64)])
    lgf = lg.float()
    for i in range(rows):
        k = int(topk[i]) or v
        thresh = torch.sort(lgf[i]).values[v - k]
        assert bool((lgf[i, draws[:, i].long()] >= thresh).all()), i
    assert len(set(draws[:, 6].tolist())) > 1  # the sampled rows do sample
