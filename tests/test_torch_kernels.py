"""The port's kernel ops against the JAX package's, on the CPU.

The same numpy inputs go through the JAX function (its Pallas kernel in
interpret mode, as the JAX package's own tests run it) and through the
port's counterpart, which on a CPU tensor runs the kernel's plain version.
Tolerances: f32 rtol/atol 1e-5 (only the order of f32 sums differs); bf16
rtol/atol 1e-2 (one bf16 rounding of the output may go the other way).
The hand-written CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.fused import fused_matmul as j_fused_matmul
from repro.kernels.packed_matmul import packed_matmul as j_packed_matmul
from repro_torch import bridge
from repro_torch.kernels import _build, ops
from repro_torch.kernels import packed_matmul as packed_module
from repro_torch.kernels.fused import fused_matmul
from repro_torch.kernels.packed_matmul import packed_matmul, packed_matmul_pair, packed_matmul_path

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype, stds=None):
    """numpy f32 arrays rounded to ``dtype``, as (jax, torch) pairs."""
    rng = np.random.RandomState(seed)
    out = []
    for i, s in enumerate(shapes):
        a = (rng.standard_normal(s) * (stds[i] if stds else 1.0)).astype(np.float32)
        j = jnp.asarray(a).astype(JDT[dtype])
        out.append((j, bridge.to_torch(np.asarray(j), "cpu")))
    return out


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,m,k,l",
    [
        (8, 1, 64, 16),      # decode xA: one token per adapter, rank-wide L
        (8, 1, 16, 72),      # decode (xA)B: the rank is the whole K
        (1, 37, 48, 24),     # prefill-like, nothing aligned
        (3, 20, 36, 52),
    ],
)
def test_packed_matmul_plain_matches_pallas(dtype, n, m, k, l):
    (jx, tx), (jw, tw) = _inputs(n * 100 + m, [(n, m, k), (n, k, l)], dtype)
    scale = np.linspace(0.5, 2.0, n).astype(np.float32)
    want = j_packed_matmul(jx, jw, jnp.asarray(scale), interpret=True)
    got = packed_matmul(tx, tw, torch.from_numpy(scale))
    assert got.dtype == TDT[dtype] and got.shape == (n, m, l)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("r", [8, 16])
@pytest.mark.parametrize("call", ["xA", "xAB", "case2", "case4"])
def test_packed_matmul_f32_launcher_calls_match_pallas(call, r):
    """The f32 calls the launcher's ``--impl auto`` makes of one rank
    segment (N = 1 adapter), at a reduced width with M and K off every tile
    (75 rows, d_in 132, d_out 196): xA, (xA)B, case 2 on B's transposed
    view and case 4 on A's, against the Pallas kernel in interpret mode on
    the transposed arrays."""
    m, d_in, d_out = 75, 132, 196
    (jx, tx), (ja, ta), (jb, tb), (jg, tg), (jd, td) = _inputs(
        40 + r, [(1, m, d_in), (1, d_in, r), (1, r, d_out), (1, m, d_out), (1, m, r)],
        "float32", stds=[1.0, d_in ** -0.5, 1.0, 1.0, 1.0])
    scale = np.array([1.5], np.float32)
    operands = {"xA": ((jx, ja), (tx, ta)),
                "xAB": ((jd, jb), (td, tb)),
                "case2": ((jg, jnp.swapaxes(jb, 1, 2)), (tg, tb.transpose(1, 2))),
                "case4": ((jd, jnp.swapaxes(ja, 1, 2)), (td, ta.transpose(1, 2)))}
    (jl, jr), (tl, tr) = operands[call]
    s = scale if call == "xAB" else None
    want = j_packed_matmul(jl, jr, None if s is None else jnp.asarray(s), interpret=True)
    got = packed_matmul(tl, tr, None if s is None else torch.from_numpy(s),
                        backward=call.startswith("case"))
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,m,k,l,r",
    [
        (8, 1, 64, 40, 16),
        (1, 33, 48, 24, 8),
        (2, 5, 40, 130, 24),
        # ragged packs: rows per adapter no multiple of 64, so the card's
        # "wgmma" path tiles each adapter's rows on their own
        (2, 150, 64, 72, 16),
        (3, 100, 128, 136, 12),
    ],
)
def test_fused_plain_matches_pallas(dtype, n, m, k, l, r):
    (jx, tx), (jw, tw), (ja, ta), (jb, tb) = _inputs(
        n + m + r, [(n, m, k), (k, l), (n, k, r), (n, r, l)], dtype,
        stds=[1.0, k ** -0.5, k ** -0.5, 1.0],
    )
    scale = np.linspace(0.5, 2.0, n).astype(np.float32)
    want = j_fused_matmul(jx, jw, ja, jb, jnp.asarray(scale), interpret=True)
    got = fused_matmul(tx, tw, ta, tb, torch.from_numpy(scale))
    assert got.dtype == TDT[dtype] and got.shape == (n, m, l)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _pack(seed, n=3, t=5, d=48, r=16, k=40):
    (jx, tx), (jw, tw), (ja, ta), (jb, tb) = _inputs(
        seed, [(n, t, d), (d, k), (n, d, r), (n, r, k)], "float32",
        stds=[1.0, d ** -0.5, d ** -0.5, 1.0],
    )
    alpha = np.array([2.0, 0.5, 1.0][:n], np.float32)
    return (jx, jw, ja, jb, jnp.asarray(alpha)), (tx, tw, ta, tb, torch.from_numpy(alpha))


@pytest.mark.parametrize("ranks", [None, (8, 16, 8)])
def test_packed_lora_delta_matches_reference(ranks):
    (jx, _, ja, jb, jal), (tx, _, ta, tb, tal) = _pack(1)
    want = jops.packed_lora_delta(jx, ja, jb, jal, impl="pallas", ranks=ranks)
    got = ops.packed_lora_delta(tx, ta, tb, tal, ranks=ranks)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ranks", [None, (8, 16, 8, 16, 16, 8, 16, 8)])
def test_packed_lora_delta_at_decode_rows_matches_reference(dtype, ranks):
    """The delta at decode rows (N = 8 adapters x M = 1 row, K = 64, r = 16;
    and a ragged pack of ranks 8 and 16), where the kernel path runs both
    passes as one ``packed_matmul_pair`` call, against the JAX package's
    Pallas kernel in interpret mode."""
    n, k, r, l = 8, 64, 16, 72
    (jx, tx), (ja, ta), (jb, tb) = _inputs(
        5, [(n, 1, k), (n, k, r), (n, r, l)], dtype, stds=[1.0, k ** -0.5, 1.0])
    alpha = np.linspace(0.5, 2.0, n).astype(np.float32)
    want = jops.packed_lora_delta(jx, ja, jb, jnp.asarray(alpha), impl="pallas", ranks=ranks)
    got = ops.packed_lora_delta(tx, ta, tb, torch.from_numpy(alpha), ranks=ranks)
    assert got.dtype == TDT[dtype] and got.shape == (n, 1, l)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_matmul_pair_equals_two_calls_and_pallas(dtype):
    """``packed_matmul_pair`` returns what ``packed_matmul(x, a)`` and then
    ``packed_matmul(xa, b, scale)`` return, bit for bit, and out agrees with
    the Pallas kernel applied twice (interpret mode)."""
    n, k, r, l = 8, 64, 16, 40
    (jx, tx), (ja, ta), (jb, tb) = _inputs(
        6, [(n, 1, k), (n, k, r), (n, r, l)], dtype, stds=[1.0, k ** -0.5, 1.0])
    scale = np.linspace(0.5, 2.0, n).astype(np.float32)
    out, xa = packed_matmul_pair(tx, ta, tb, torch.from_numpy(scale))
    want_xa = packed_matmul(tx, ta)
    assert torch.equal(xa, want_xa)
    assert torch.equal(out, packed_matmul(want_xa, tb, torch.from_numpy(scale)))
    jxa = j_packed_matmul(jx, ja, jnp.ones((n,), jnp.float32), interpret=True)
    want = j_packed_matmul(jxa, jb, jnp.asarray(scale), interpret=True)
    np.testing.assert_allclose(_np(xa), _np(jxa), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(want), **TOL[dtype])


@pytest.mark.parametrize("ranks", [None, (8, 16, 8)])
def test_fused_lora_linear_matches_reference(ranks):
    (jx, jw, ja, jb, jal), (tx, tw, ta, tb, tal) = _pack(2)
    want = jops.fused_lora_linear(jx, jw, ja, jb, jal, impl="fused_pallas", ranks=ranks)
    got = ops.fused_lora_linear(tx, tw, ta, tb, tal, impl="fused", ranks=ranks)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_rank_padding_is_exactly_zero(impl):
    """Adapters zero-padded to the bucket rank: whatever the padding rows of
    B hold, the output is bitwise that of zero padding, and the ragged
    segments (padding sliced away) agree with it to rounding."""
    _, (tx, tw, ta, tb, tal) = _pack(3)
    ranks = (8, 16, 8)
    mask = (torch.arange(16)[None, :] < torch.tensor(ranks)[:, None]).float()
    a0 = ta * mask[:, None, :]
    b0 = tb * mask[:, :, None]
    b_junk = b0 + (1 - mask[:, :, None]) * 123.0

    def run(b, rk):
        if impl == "fused":
            return ops.fused_lora_linear(tx, tw, a0, b, tal, impl=impl, ranks=rk)
        return ops.packed_lora_delta(tx, a0, b, tal, impl=impl, ranks=rk)

    assert torch.equal(run(b0, None), run(b_junk, None))
    np.testing.assert_allclose(_np(run(b_junk, ranks)), _np(run(b0, None)), **TOL["float32"])


def test_rank_segments_matches_reference():
    for ranks in [(8,), (16, 8, 16, 8, 32), (8, 8, 8)]:
        assert ops.rank_segments(ranks) == tuple(jops.rank_segments(ranks))[:2] + (
            list(jops.rank_segments(ranks)[2]),
        )


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown impl"):
        ops.KernelConfig(impl="xla").resolved_impl()


@pytest.mark.parametrize("kernel", ["packed_matmul", "fused_matmul"])
def test_wrapper_takes_plain_version_on_cpu_without_counting(kernel):
    """On a CPU tensor the wrapper runs the plain version: no launch."""
    (jx, tx), (jw, tw), (ja, ta), (jb, tb) = _inputs(0, [(2, 3, 8), (2, 8, 4), (8, 4), (2, 4, 4)], "float32")
    fn = packed_matmul if kernel == "packed_matmul" else fused_matmul
    before = dict(fn.launches)
    if kernel == "packed_matmul":
        fn(tx, tw)
    else:
        fn(tx, tw[0], tw, tb)
    assert fn.launches == before


def test_packed_matmul_path_raises_on_cpu():
    """The path query reads the CUDA library's plan: a CPU tensor has none."""
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        packed_matmul_path(torch.zeros(2, 32, 16), torch.zeros(2, 16, 8))


WRAPPERS = {"packed_matmul.py": ("packed_matmul",), "fused.py": ("fused", "fused_q")}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_signatures_name_every_c_function_the_wrapper_calls(wrapper):
    """Every C function a wrapper calls has its ctypes signature in
    ``_build.SIGNATURES`` under a library the wrapper loads (without one,
    ctypes would pass each pointer as a 32-bit int), and every declared
    function is defined by that library's source."""
    kdir = Path(packed_module.__file__).parent
    libs = WRAPPERS[wrapper]
    assert set(re.findall(r'_build\.load\("(\w+)"\)', (kdir / wrapper).read_text())) == set(libs)
    called = set(re.findall(r"\b(plora_\w+)\(", (kdir / wrapper).read_text()))
    declared = {f for lib in libs for f in _build.SIGNATURES[lib]}
    assert called and called <= declared, called - declared
    for lib in libs:
        src = (kdir / "csrc" / f"{lib}.cu").read_text()
        for fname in _build.SIGNATURES[lib]:
            assert re.search(r'extern "C" [^(]*\b' + fname + r"\(", src), (lib, fname)


@pytest.mark.parametrize(
    "shape", [(2, 5, 7), (1, 5, 7), (2, 1, 7), (2, 5, 1), (1, 1, 1), (3, 4, 4), (5, 7), (2, 3, 5, 7)]
)
def test_transposed_layout_reads_the_strides(shape):
    """The wrappers tell a transposed view of a contiguous tensor from the
    strides alone, as ``transpose(-1, -2).is_contiguous()`` would (size-1
    dims included; a view that is contiguous as well counts as
    contiguous), and refuse any other layout."""
    *lead, a, b = shape
    views = [torch.zeros(shape), torch.zeros(*lead, b, a).transpose(-1, -2),
             torch.zeros(*lead, a, 2 * b)[..., ::2], torch.zeros(*lead, 2 * a, b)[..., ::2, :]]
    for v in views:
        if v.is_contiguous() or v.transpose(-1, -2).is_contiguous():
            assert packed_module._transposed(v, "t") == int(not v.is_contiguous())
        else:
            with pytest.raises(ValueError, match="contiguous"):
                packed_module._transposed(v, "t")
    assert packed_module._transposed(views[1], "t") == int(a > 1 and b > 1)


def _c_enum(src: str, prefix: str):
    """The ``PATH_*`` enum of a CUDA source: name -> value."""
    body = re.search(r"enum\s*\{([^}]*" + prefix + r"[^}]*)\}", src).group(1)
    return {name: int(v) for name, v in re.findall(r"(" + prefix + r"\w+)\s*=\s*(\d+)", body)}


@pytest.mark.parametrize("module,source", [("fused", "fused.cuh"), ("packed_matmul", "skinny.cuh")])
def test_paths_agree_with_the_plan_enum(module, source):
    """A wrapper's ``PATHS`` names the plan's ``PATH_*`` values in order, so
    a path index the C plan returns reads as the right name (``ffma`` is
    ``PATH_FFMA``, and so on)."""
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    enum = _c_enum((Path(mod.__file__).parent / "csrc" / source).read_text(), "PATH_")
    assert sorted(enum.values()) == list(range(len(mod.PATHS)))
    assert {v: k[len("PATH_"):].lower() for k, v in enum.items()} == dict(enumerate(mod.PATHS))


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_parameter_counts(lib):
    """Each declared ctypes signature has as many arguments as the C
    function has parameters (a plan query that gains a flag must gain it
    on both sides)."""
    src = (Path(_build.__file__).parent / "csrc" / f"{lib}.cu").read_text()
    for fname, (_, argtypes) in _build.SIGNATURES[lib].items():
        params = re.search(r'extern "C" [^(]*\b' + fname + r"\(([^)]*)\)", src).group(1)
        assert len(argtypes) == len([p for p in params.split(",") if p.strip()]), (lib, fname)


def test_path_counts_leave_a_capture_and_return_per_replay():
    """Each wrapper's one count, by direction and path, gives both the
    totals (``read``) and the launches by path (``read_paths``): a capture
    takes what it recorded out, each replay adds it back, ``zero`` clears."""
    from repro_torch.kernels import launches
    from repro_torch.kernels.fused import fused_matmul_q

    launches.zero()
    fused_matmul.launches["fwd", "ffma"] += 3  # an eager step
    with launches.recorded() as calls:
        fused_matmul.launches["fwd", "ffma"] += 2
        fused_matmul.launches["bwd", "ffma"] += 1
        packed_matmul.launches["bwd", "fma"] += 4
    assert calls == {("fused_matmul", "fwd", "ffma"): 2, ("fused_matmul", "bwd", "ffma"): 1,
                     ("packed_matmul", "bwd", "fma"): 4}
    assert launches.read_paths()["fused_matmul"]["ffma"] == 3
    for _ in range(2):
        launches.add(calls)
    paths = launches.read_paths()
    assert paths["fused_matmul"] == {"split3": 0, "wgmma": 0, "decode": 0, "ffma": 9}
    assert paths["packed_matmul"] == {"fma": 8, "mma": 0, "decode": 0, "f32skinny": 0}
    assert set(paths["fused_matmul_q"]) == {p for _, p in fused_matmul_q.launches}
    assert launches.read() == {"packed_matmul": 0, "packed_matmul_bwd": 8, "fused_matmul": 7,
                               "fused_matmul_dx": 2, "fused_matmul_q": 0}
    launches.zero()
    assert all(k == 0 for p in launches.read_paths().values() for k in p.values())
