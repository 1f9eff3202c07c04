"""The port's memory price of a quantized frozen base (ROADMAP C6).

``quantize_base_params`` turns only the projections of
``kernels.quant.ELIGIBLE_NAMES`` into codes; the embedding, the LM head,
the norms and MLA's ``kv_b_k`` / ``kv_b_v`` stay in the tree's dense dtype.
The port's ``CostModel`` prices those leaves at that dtype
(``dense_dtype``) and a quantized base's activations at its compute dtype
(4 bytes on the launcher's f32 base); dense bases keep their prices bit for
bit, and ``REFERENCE_MEMORY`` gives the reference's prices back (``==``).
"""
import pytest
import torch

from repro.configs.base import default_search_space as j_space
from repro.configs.base import get_config as j_get_config
from repro.sched import cost_model as jcm
from repro_torch.configs import LoraConfig, default_search_space, get_config, reduced
from repro_torch.kernels.quant import base_storage, is_quantized, logical_shape
from repro_torch.launch import train as launch_train
from repro_torch.models.model import init_model
from repro_torch.sched import cost_model as tcm
from repro_torch.sched.engine import ExecutionEngine
from repro_torch.sched.planner import Schedule, ScheduledJob

ARCHS = ("qwen25-7b", "starcoder2-7b", "gemma3-1b", "command-r-35b", "minicpm3-4b")
MODES = ("int8", "nf4")
BYTES = {None: 2.0, "bf16": 2.0, "f32": 4.0}
# the chip smoke's train pack (ranks 8, 16, 16, 32, batch 1, 2, 1, 2) and
# the command-r launcher's (ranks 8, 16, batch 1 each), seq 512
TRAIN_PACK = [LoraConfig(rank=r, alpha=2.0 * r, learning_rate=1e-4, batch_size=b, seq_len=512)
              for r, b in zip((8, 16, 16, 32), (1, 2, 1, 2))]
LAUNCH_PACK = [LoraConfig(rank=r, alpha=2.0 * r, learning_rate=1e-4, batch_size=1, seq_len=512)
               for r in (8, 16)]


def _quantized_elements(tree) -> int:
    """Dense parameters behind the tree's quantized leaves."""
    if is_quantized(tree):
        n = 1
        for s in logical_shape(tree):
            n *= s
        return n
    if isinstance(tree, dict):
        return sum(_quantized_elements(v) for v in tree.values())
    return 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_count_is_what_the_quantizer_quantizes(arch, mode):
    """``quantized_param_count`` counts exactly the parameters that
    ``init_model(..., quant=mode)`` stores as codes (the price and the
    quantizer read one list of names), on every family's reduced tree."""
    cfg = reduced(get_config(arch))
    base, _ = init_model(0, cfg, None, device="cpu", quant=mode)
    assert tcm.quantized_param_count(cfg, mode) == _quantized_elements(base) > 0


@pytest.mark.parametrize("dense", [None, "bf16", "f32"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["command-r-35b", "minicpm3-4b"])
def test_quantized_base_prices_its_dense_leaves_at_their_dtype(arch, mode, dense):
    """The codes at the scheme's bytes, the rest at ``dense_dtype``'s: for
    command-r-35b the tied embedding, for minicpm3-4b the embedding, the
    head and every layer's kv_b_k / kv_b_v. Without ``price_dense_leaves``
    every parameter is billed at the scheme's bytes (the reference's)."""
    cfg = get_config(arch)
    a, d = cfg.attention, cfg.d_model
    n, q = tcm.model_param_count(cfg), tcm.quantized_param_count(cfg, mode)
    kept = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if a.is_mla:
        kept += cfg.n_layers * a.kv_lora_rank * a.n_heads * (a.qk_nope_head_dim + a.v_head_dim)
    assert n - q == kept
    cm = tcm.CostModel(cfg, tcm.H100, base_dtype=mode, dense_dtype=dense)
    scheme = tcm.base_param_bytes(mode)
    assert cm.base_weight_bytes() == q * scheme + kept * BYTES[dense]
    old = tcm.CostModel(cfg, tcm.H100, base_dtype=mode, dense_dtype=dense, price_dense_leaves=False)
    assert old.base_weight_bytes() == n * scheme
    assert (cm.job_mem_bytes(TRAIN_PACK, 1, 512) - old.job_mem_bytes(TRAIN_PACK, 1, 512)
            == pytest.approx(kept * (BYTES[dense] - scheme), rel=1e-12))


def test_quantized_base_activations_at_its_compute_dtype():
    """An f32-x quantized base (the launcher's) prices its activations at 4
    bytes an element, a bf16 one at ``prec_bytes``; the command-r launcher's
    nf4 pack gains the f32 embedding and the f32 activations."""
    cfg = get_config("command-r-35b")
    f32, bf16, none = (tcm.CostModel(cfg, tcm.H100, base_dtype="nf4", dense_dtype=dt)
                       for dt in ("f32", "bf16", None))
    assert f32.compute_dtype() == "f32" and none.compute_dtype() is None
    assert f32.base_act_bytes(2, 512) == 2 * bf16.base_act_bytes(2, 512) == 2 * none.base_act_bytes(
        2, 512)
    ref = tcm.CostModel(cfg, tcm.H100, base_dtype="nf4", price_dense_leaves=False)
    grown = f32.job_mem_bytes(LAUNCH_PACK, 1, 512) - ref.job_mem_bytes(LAUNCH_PACK, 1, 512)
    emb = cfg.vocab_size * cfg.d_model * (4.0 - tcm.base_param_bytes("nf4"))
    act = f32.base_act_bytes(2, 512) - ref.base_act_bytes(2, 512)
    assert act == 12.0 * 2 * 512 * cfg.d_model * 2.0
    assert grown == pytest.approx(emb + act, rel=1e-12)
    assert 7.3e9 < grown < 7.5e9  # +7.19 GB of f32 embedding, +0.20 GB of f32 activations


@pytest.mark.parametrize("base_dtype", [None, "bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_bases_price_as_before(arch, base_dtype):
    """A dense base ignores ``dense_dtype`` and ``price_dense_leaves``: every
    parameter at its storage's bytes, activations at its compute dtype's,
    bit for bit the formula before the repair."""
    cfg = get_config(arch)
    plain = tcm.CostModel(cfg, tcm.H100, base_dtype=base_dtype)
    n, b = tcm.model_param_count(cfg), BYTES[base_dtype]
    assert plain.base_weight_bytes() == n * b
    assert plain.base_act_bytes(6, 512) == 12.0 * 6 * 512 * cfg.d_model * (
        4.0 if base_dtype == "f32" else 2)
    for kw in (dict(dense_dtype="f32"), dict(dense_dtype="bf16"), dict(price_dense_leaves=False)):
        other = tcm.CostModel(cfg, tcm.H100, base_dtype=base_dtype, **kw)
        assert other.job_mem_bytes(TRAIN_PACK, 1, 512) == plain.job_mem_bytes(TRAIN_PACK, 1, 512)
        assert other.iter_time(TRAIN_PACK, 1, 512) == plain.iter_time(TRAIN_PACK, 1, 512)


@pytest.mark.parametrize("base_dtype", [None, "int8", "nf4"], ids=["none", "int8", "nf4"])
@pytest.mark.parametrize("arch", ["qwen25-7b", "gemma3-1b", "command-r-35b"])
def test_reference_memory_gives_the_reference_prices(arch, base_dtype):
    """With ``REFERENCE_MEMORY`` (``price_dense_leaves=False`` among it) the
    port's prices of a quantized base ``==`` the reference's, at full width:
    every parameter at the scheme's bytes, activations at ``prec_bytes``."""
    jc, tc = j_get_config(arch), get_config(arch)
    jm = jcm.CostModel(jc, jcm.A100_40G, base_dtype=base_dtype)
    tmod = tcm.CostModel(tc, tcm.A100_40G, base_dtype=base_dtype, **tcm.REFERENCE_MEMORY)
    assert tmod.base_weight_bytes() == jm.base_weight_bytes()
    assert tmod.base_act_bytes(4, 512) == jm.base_act_bytes(4, 512)
    js, ts = j_space(300, seq_len=512)[::37], default_search_space(300, seq_len=512)[::37]
    for k in (1, 4, len(ts)):
        assert tmod.job_mem_bytes(ts[:k], 1, 512) == jm.job_mem_bytes(js[:k], 1, 512)
        assert tmod.iter_time(ts[:k], 1, 512) == jm.iter_time(js[:k], 1, 512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_base_storage_reports_the_dense_dtype(dtype):
    """``base_storage(tree, dense=True)``: the storage and the dtype of the
    dense leaves, for a dense tree and a quantized one; the plain call
    still names the storage alone."""
    cfg = reduced(get_config("minicpm3-4b"))
    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    dense, _ = init_model(0, cfg, None, dtype, device="cpu")
    assert base_storage(dense, dense=True) == (name, name)
    for mode in MODES:
        q, _ = init_model(0, cfg, None, dtype, device="cpu", quant=mode)
        assert base_storage(q) == mode and base_storage(q, dense=True) == (mode, name)
    with pytest.raises(ValueError, match="one float32 or bfloat16"):
        base_storage({"w": torch.zeros(2, dtype=torch.float16)}, dense=True)


def test_engine_refuses_a_quantized_tree_priced_at_other_dense_leaves():
    """``run_local`` raises before it runs anything when an int8 tree's
    dense leaves are f32 and the model prices them at 2 bytes; priced with
    ``dense_dtype="f32"`` (or a bf16 tree at the default) it passes."""
    cfg = reduced(get_config("minicpm3-4b"))
    f32, _ = init_model(0, cfg, None, device="cpu", quant="int8")
    bf16, _ = init_model(0, cfg, None, torch.bfloat16, device="cpu", quant="int8")
    configs = [LoraConfig(rank=8, alpha=8.0, batch_size=1, seq_len=16)]
    sched = Schedule([ScheduledJob((0,), 1, 0.0, 1.0)], 1.0, 1)
    eng = ExecutionEngine(tcm.CostModel(cfg, tcm.A100_40G, base_dtype="int8"), 1)
    with pytest.raises(ValueError, match="dense_dtype='f32'"):
        eng.run_local(sched, configs, cfg, f32, n_steps=1, seq=16)
    eng._check_base(bf16)
    ExecutionEngine(tcm.CostModel(cfg, tcm.A100_40G, base_dtype="int8", dense_dtype="f32"),
                    1)._check_base(f32)


def test_launcher_prices_its_quantized_tree(monkeypatch):
    """``--quant nf4`` on the launcher's f32 base: its ``CostModel`` prices
    the nf4 codes and the f32 dense leaves and activations."""
    seen = []
    real = launch_train.CostModel

    def spy(*args, **kw):
        seen.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(launch_train, "CostModel", spy)
    per = launch_train.main(["--arch", "minicpm3-4b", "--reduced", "--device", "cpu", "--steps",
                             "1", "--seq", "16", "--log-every", "0", "--quant", "nf4"])
    assert per.shape == (2,)
    assert (seen[-1]["base_dtype"], seen[-1]["dense_dtype"]) == ("nf4", "f32")
