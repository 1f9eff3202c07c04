"""The weight bridge, adapter extraction/injection, and the port's import
boundary.

Round trip JAX → numpy → port → numpy is bit-exact for f32 and bf16 trees;
``extract_adapter``/``inject_adapter`` equal the JAX package's exactly (pure
memory movement). An AST scan holds ``src/repro_torch`` and ``chip_smoke.py``
to importing neither ``jax``/``jaxlib`` nor the JAX package ``repro``.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LoraConfig as JLoraConfig
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.core.adapter import pack_meta as j_pack_meta
from repro.core.packed_lora import extract_adapter as j_extract
from repro.core.packed_lora import inject_adapter as j_inject
from repro.models.model import init_model as j_init_model
from repro_torch import bridge
from repro_torch.core.packed_lora import extract_adapter, inject_adapter

ROOT = Path(__file__).resolve().parents[1]
RANKS = (8, 16)


@pytest.fixture(scope="module")
def trees():
    cfg = j_reduced(j_get_config("qwen25-7b"))
    meta = j_pack_meta([JLoraConfig(rank=r, alpha=2.0 * r) for r in RANKS])
    base, lora = j_init_model(jax.random.PRNGKey(1), cfg, meta)
    lora = jax.tree.map(lambda x: x + 0.02, lora)
    return jax.tree.map(np.asarray, base), jax.tree.map(np.asarray, lora)


def _assert_bitwise(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(trees, dtype):
    base, lora = trees
    for tree in (base, lora):
        if dtype == "bfloat16":
            tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)), tree)
        t = bridge.to_torch(tree, "cpu")
        want_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
        assert all(leaf.dtype == want_dtype for leaf in jax.tree_util.tree_leaves(t))
        _assert_bitwise(bridge.to_numpy(t), tree)


def test_layout_is_unchanged(trees):
    base, lora = trees
    t = bridge.to_torch(base, "cpu")
    assert t["decoder"]["blocks"]["l0"]["attn"]["q"]["w"].shape == base["decoder"]["blocks"]["l0"]["attn"]["q"]["w"].shape
    tl = bridge.to_torch(lora, "cpu")
    # pack axis 1 under "blocks" (axis 0 is the layer)
    assert tl["decoder"]["blocks"]["l0"]["mlp"]["up"]["a"].shape[1] == len(RANKS)


@pytest.mark.parametrize("ranks", [None, RANKS])
def test_extract_adapter_matches_reference(trees, ranks):
    _, lora = trees
    tl = bridge.to_torch(lora, "cpu")
    for idx in range(len(RANKS)):
        _assert_bitwise(extract_adapter(tl, idx, ranks=ranks), j_extract(lora, idx, ranks=ranks))


def test_inject_adapter_matches_reference_and_round_trips(trees):
    _, lora = trees
    small = j_extract(lora, 0, ranks=RANKS)  # rank 8, to be zero-padded to 16
    for idx in range(len(RANKS)):
        got = inject_adapter(bridge.to_numpy(bridge.to_torch(lora, "cpu")), small, idx)
        _assert_bitwise(got, j_inject(lora, small, idx))
        _assert_bitwise(extract_adapter(got, idx, ranks=(8, 8)), small)
        # padding re-introduced as exact zeros
        a = got["decoder"]["blocks"]["l0"]["attn"]["q"]["a"][:, idx]
        assert not a[..., 8:].any()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_imports_neither_jax_nor_reference(path):
    banned = {"jax", "jaxlib", "repro"}
    bad = [m for m in _imports(path) if m.split(".")[0] in banned]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
