"""Cost model for packed LoRA fine-tuning jobs (the port of
``repro/sched/cost_model.py``; paper §4 and Appendix A).

Memory follows Appendix A: base weights + base activations (on the max
packed batch) + per-adapter params/grads/optimizer-moments/activations, all
divided by the parallelism degree d; a load factor C guards fragmentation.
The port prices what it holds at a step's peak (f32 LoRA state, the
cross-entropy's f32 logits, a fixed per-job term, fitted on an H100);
``REFERENCE_MEMORY`` gives the reference's accounting back.

Time is a three-term roofline per iteration (compute, HBM, interconnect)
plus a per-layer fixed overhead, so the paper's observation -- tiny batches
underuse the device and packing raises throughput at nearly constant cost --
emerges from the model. ``calibrate`` fits one efficiency scalar from
profiled iterations.

Every consumer (knapsack, DTM, planner, engine, cluster runner) programs
against :class:`CostEstimator`; the analytic :class:`CostModel` is the
prior, and :class:`repro_torch.sched.profile.ProfiledCostModel` layers
measured step times on top of it. The port's copy differs from the
reference in three places: an ``H100`` preset, parameter counts for the
families the port has (dense GQA and MLA decoders, SSM decoders,
decoders with mixture-of-experts FFNs, attention/SSD hybrids with dense
and MoE FFNs, the encoder-decoder and the patch-prefix VLM; a config of
another kind raises),
and the memory accounting above. Every other number is the
reference's, so with ``REFERENCE_MEMORY`` the two plan alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.configs.base import (
    MLP_PROJECTIONS,
    LoraConfig,
    ModelConfig,
    attn_projections,
    layer_projections,
    lora_layout,
    stack_layers,
)
from repro_torch.kernels.quant import ELIGIBLE_NAMES, MODES
from repro_torch.models.transformer import find_period, layer_specs


class CostEstimator:
    """Interface of the estimation layer (tentpole of the profile feedback
    loop): what the packing solver, DTM, planner, and execution engine are
    allowed to ask about a candidate packed job.

    Subclasses provide the three core queries — per-iteration time, memory
    feasibility, minimum degree — plus a ``setup_time`` attribute; the
    job-level queries below derive from those, so a subclass that changes
    ``iter_time`` (e.g. by consulting measured timings) automatically
    re-prices every downstream planning decision.

    The analytic :class:`CostModel` is the pure *prior*: deterministic,
    state-free, used by the virtual-clock simulator. The profiled layer
    (:class:`repro_torch.sched.profile.ProfiledCostModel`) additionally implements
    the measurement-feedback hooks (``observe``/``observed``) and reports
    ``adaptive = True``, which switches the engine's real execution path to
    re-plan on live device-free events.
    """

    # ---------------- core queries (subclass responsibility) ----------------

    def iter_time(self, configs: Sequence[LoraConfig], d: int, seq: int) -> float:
        """Seconds per packed training iteration on ``d`` device units."""
        raise NotImplementedError

    def fits(self, configs: Sequence[LoraConfig], d: int, seq: int) -> bool:
        raise NotImplementedError

    def min_degree(self, configs: Sequence[LoraConfig], seq: int) -> Optional[int]:
        raise NotImplementedError

    # ---------------- derived job-level queries ----------------

    def job_time(
        self, configs: Sequence[LoraConfig], d: int, seq: int, n_steps: int
    ) -> float:
        return self.job_time_residual(configs, [n_steps] * len(configs), d, seq)

    def job_time_residual(
        self,
        configs: Sequence[LoraConfig],
        steps: Sequence[int],
        d: int,
        seq: int,
    ) -> float:
        """Per-job residual-step cost query (online engine): adapters resumed
        from a preempted job carry fewer remaining steps than fresh arrivals,
        and a packed job holds its devices until its longest-residual adapter
        finishes. ``steps[i]`` is the remaining iteration count of
        ``configs[i]``; the job pays setup once plus ``max(steps)``
        packed iterations."""
        if not configs:
            return self.setup_time
        return self.setup_time + max(steps) * self.iter_time(configs, d, seq)

    def adapter_finish_offset(
        self, configs: Sequence[LoraConfig], steps: int, d: int, seq: int
    ) -> float:
        """Seconds from job launch until an adapter with ``steps`` residual
        iterations is done training (it may ride along until the pack's
        longest adapter finishes, but its own weights stop changing here)."""
        return self.setup_time + steps * self.iter_time(configs, d, seq)

    def throughput(self, configs: Sequence[LoraConfig], d: int, seq: int) -> float:
        """Paper Eq (13): LoRA FLOP per unit time. LoRA FLOP is linear in
        rank (§2.1) and, with heterogeneous batch sizes, in rank * batch."""
        return sum(c.rank * c.batch_size for c in configs) / self.iter_time(
            configs, d, seq
        )

    # ---------------- measurement feedback (no-op for pure priors) ----------

    def observe(
        self,
        configs: Sequence[LoraConfig],
        d: int,
        seq: int,
        measured_iter_time: float,
    ) -> None:
        """Feed one measured per-iteration wall time back into the estimator.
        The analytic prior ignores it; the profiled layer folds it into its
        observation store."""

    def observed(self, configs: Sequence[LoraConfig], d: int, seq: int) -> bool:
        """Whether this exact (pack shape, degree, seq) has been measured."""
        return False

    # ---------------- heterogeneous fleets (class-blind by default) ---------

    #: estimators that price per host class (extra ``host_class=`` kwarg on
    #: iter_time/observe/observed/drift) advertise True; the engine only
    #: passes class tags when this is set
    class_aware = False

    def class_ratio(self, host_class: str, d: Optional[int] = None) -> float:
        """Measured slowdown of a host class vs this estimator's baseline
        (1.0 = unknown/identical) — placement ranking for heterogeneous
        fleets. Pure priors have no measurements: always 1.0."""
        return 1.0

    # ---------------- simulation contract ----------------

    @property
    def adaptive(self) -> bool:
        """True when real execution should re-plan against live measurements."""
        return False

    def virtual_model(self) -> "CostEstimator":
        """The pure prior used by the virtual-clock simulator — simulation
        must stay deterministic and independent of any measurement state."""
        return self


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    mem_bytes: float  # per device unit
    peak_flops: float  # per device unit (bf16)
    hbm_bw: float  # bytes/s per device unit
    link_bw: float  # bytes/s per link (TP collective)
    n_devices: int = 8
    efficiency: float = 0.5  # asymptotic fraction of peak in large GEMMs
    # tokens-per-device at which GEMM efficiency reaches half its asymptote —
    # THE paper effect: tiny per-device batches run far below peak (SM
    # occupancy 16.7%, §3.1), so adding packed adapters is nearly free until
    # the device saturates. eff(tpd) = efficiency * tpd / (tpd + sat_tokens).
    sat_tokens: float = 600.0
    # per-layer fixed overhead per iteration (kernel launch / dispatch /
    # framework); not divided by the parallelism degree. Calibrated so a
    # bs=1 short-seq iteration is overhead-dominated (paper §5.1: iteration
    # time grows only ~10% from bs 1 -> 8 on GLUE-scale sequences).
    layer_overhead: float = 12.5e-3
    # extra per-adapter per-iteration cost of the NAIVE sequential adapter
    # loop (paper §5.1: packing 8 adapters naively is 3.6x slower than one
    # adapter — small launches + low arithmetic intensity). PLoRA's packed
    # kernels eliminate this term.
    seq_adapter_overhead: float = 0.14

    def eff(self, tokens_per_device: float) -> float:
        t = max(tokens_per_device, 1.0)
        return self.efficiency * t / (t + self.sat_tokens)

    def scaled(self, **kw) -> "HardwareSpec":
        import dataclasses

        return dataclasses.replace(self, **kw)


# Presets: the paper's testbeds and the reference's TPU target, with the
# reference's values (sat_tokens/layer_overhead fitted there to the paper's
# §5.1 anchors).
A100_40G = HardwareSpec("a100-40g", 40e9, 312e12, 2.0e12, 300e9, 8,
                        sat_tokens=600.0, layer_overhead=12.5e-3,
                        seq_adapter_overhead=0.14)
A10_24G = HardwareSpec("a10-24g", 24e9, 125e12, 0.6e12, 32e9, 8,
                       sat_tokens=300.0, layer_overhead=18e-3,
                       seq_adapter_overhead=0.2)
TPU_V5E = HardwareSpec("tpu-v5e", 16e9, 197e12, 819e9, 50e9, 256,
                       sat_tokens=1_500.0, layer_overhead=0.2e-3,
                       seq_adapter_overhead=0.01)
# One NVIDIA H100 SXM (80 GB HBM3 at 3.35 TB/s, 989 TFLOP/s dense bf16,
# NVLink 450 GB/s each way; NVIDIA's data sheet), eight to a host.
# sat_tokens / layer_overhead / seq_adapter_overhead stay the A100's: a fit
# of the first two to the port's measured captured steps (chip_smoke.py's
# sweep phase, in PERF.md) changes no plan and leaves errors of about
# 10 %, since those steps are linear in tokens at a lower asymptotic
# efficiency, which the fit cannot express. ProfiledCostModel carries the
# measured times.
H100 = HardwareSpec("h100", 80e9, 989e12, 3.35e12, 450e9, 8,
                    sat_tokens=600.0, layer_overhead=12.5e-3,
                    seq_adapter_overhead=0.14)

PRESETS = {hw.name: hw for hw in (A100_40G, A10_24G, TPU_V5E, H100)}

# sequence positions per chunk of the cross-entropy's logits
# (``make_packed_step``'s ``vocab_chunk``, ``train/losses.py``)
CE_CHUNK = 512
# query positions per chunk of the attention (``make_packed_step``'s
# ``chunk_q``, ``models/layers/attention.py``)
ATTN_CHUNK = 512

# The reference's memory accounting (``repro/sched/cost_model.py``): bf16
# LoRA state billed at prec_bytes * (1 + opt_factor) = 8 bytes a parameter
# at the defaults, 1 GB per adapter, no logits workspace and no per-job term.
# ``CostModel(cfg, hw, **REFERENCE_MEMORY)`` plans as the reference does.
REFERENCE_MEMORY = dict(lora_state_bytes=8.0, logits_copies=0.0, job_overhead_bytes=0.0,
                        ssm_scan_copies=0.0, enc_attn_copies=0.0, adapter_overhead_bytes=1.0e9,
                        price_dense_leaves=False)


# the layer kinds the port counts: dense decoders (``attn`` mixers,
# ``dense`` FFNs), SSM ones (``ssm`` mixers, no FFN), MoE ones (``attn``
# mixers, ``moe`` FFNs on every layer, or every ``moe_every``-th with
# ``dense`` ones between) and hybrids (``attn`` and ``ssm`` mixers,
# ``dense`` and ``moe`` FFNs: jamba)
PORTED_KINDS = ({"attn", "dense"}, {"ssm", "none"}, {"attn", "moe"}, {"attn", "dense", "moe"},
                {"attn", "ssm", "dense", "moe"})


def _ported_only(cfg: ModelConfig) -> None:
    kinds = set(cfg.layer_kinds()) | set(cfg.ffn_kinds())
    if kinds not in PORTED_KINDS or (cfg.is_encdec and (kinds != {"attn", "dense"}
                                                        or cfg.attention.is_mla)):
        raise ValueError(f"{cfg.name}: the port counts dense GQA or MLA decoders, SSM "
                         f"decoders, MoE decoders, attention/SSD hybrids and GQA "
                         f"encoder-decoders only, got {kinds}")
    if cfg.mlp_kind not in MLP_PROJECTIONS or cfg.norm_kind not in ("rmsnorm", "layernorm"):
        raise ValueError(f"{cfg.name}: unknown mlp_kind {cfg.mlp_kind!r} or norm_kind "
                         f"{cfg.norm_kind!r}")


def _live_mixers(cfg: ModelConfig):
    """The mixers whose activations a training step's backward holds at
    once: one checkpointed block's, recomputed whole, and the remainder's,
    which are not checkpointed (``models.transformer``'s grouping)."""
    specs = layer_specs(cfg)
    p = find_period(specs)
    return [s.mixer for s in specs[:p] + specs[len(specs) - len(specs) % p:]]


def moe_param_count(cfg: ModelConfig) -> float:
    """One MoE layer's experts (3 matrices of d x d_expert each) and router
    (d x E), as the reference counts them."""
    m = cfg.moe
    return float(m.n_experts * 3 * cfg.d_model * m.d_expert + cfg.d_model * m.n_experts)


def model_param_count(cfg: ModelConfig) -> float:
    """Total parameters (embeddings + stack): the reference's accounting
    for ``attn`` mixers, GQA or MLA, with ``dense`` FFNs (2 MLP matrices
    for "gelu2", 3 otherwise) or ``moe`` ones (``moe_param_count``), and
    for ``ssm`` mixers (zx, bc, dt and out) with none; one vocabulary
    matrix when tied. An encoder-decoder adds its encoder's layers and each
    decoder layer's cross-attention q/k/v/o. Norms, biases, the conv, the
    SSD's per-head vectors and a VLM's ``patch_proj`` are not counted, as
    in the reference."""
    _ported_only(cfg)
    total = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    for layers in stack_layers(cfg).values():
        for mixer, ffn, cross in layers:
            total += sum(din * dout for din, dout in layer_projections(cfg, mixer, ffn).values())
            if cross:
                total += sum(din * dout for din, dout in
                             attn_projections(cfg.attention, cfg.d_model).values())
            if ffn == "moe":
                total += moe_param_count(cfg)
    return float(total)


def quantized_param_count(cfg: ModelConfig, mode: str) -> float:
    """Parameters that ``quantize_base_params(tree, mode)`` turns into codes:
    the projections of ``kernels.quant.ELIGIBLE_NAMES`` (nf4: of even d_in).
    The embedding, the LM head, the norms, MLA's ``kv_b_k``/``kv_b_v``,
    SSD's ``bc``/``dt``, an MoE layer's experts and router, the
    cross-attention and ``patch_proj`` stay dense; an encoder's layers are
    quantized as the decoder's."""
    return float(sum(
        din * dout for layers in stack_layers(cfg).values() for mixer, ffn, _ in layers
        for nm, (din, dout) in layer_projections(cfg, mixer, ffn).items()
        if nm in ELIGIBLE_NAMES and (mode == "int8" or din % 2 == 0)))


def active_param_count(cfg: ModelConfig) -> float:
    """Parameters touched per token: all of them, less the experts a token
    is not routed to (E - top_k of each MoE layer's), as the reference."""
    total = model_param_count(cfg)
    if cfg.moe.enabled:
        m = cfg.moe
        moe_layers = sum(1 for f in cfg.ffn_kinds() if f == "moe")
        total -= moe_layers * 3 * cfg.d_model * m.d_expert * (m.n_experts - m.top_k)
    return float(total)


def lora_param_count(cfg: ModelConfig, rank: int) -> float:
    """Packed-LoRA params for one adapter: each layer's own adapters
    (``lora_layout``: the ``cfg.lora_targets`` its mixer and FFN have), at
    the widths of the projection each adapts. The reference bills every
    target named on every layer (``repro/sched/cost_model.py:237-260``), so
    for a "gelu2" MLP it bills a ``gate`` adapter that its ``init_mlp``
    never builds: n_layers x r x (d + d_ff) more than the port; it bills
    MLA's ``o`` at ``n_heads * head_dim`` inputs, where the projection reads
    ``n_heads * v_head_dim``: n_layers x r x n_heads x (head_dim -
    v_head_dim) more; and on a hybrid it bills q/k/v/o on the SSD layers
    and ssm_in/ssm_out on the attention ones (ROADMAP C, "Found in the
    reference"). SSD's "ssm_in" and "ssm_out" adapt ``zx`` and ``out``,
    billed as in the reference. An encoder-decoder's encoder layers hold
    their own adapters, and its decoder layers the "cross" group's too,
    which the reference leaves out of its bill (whisper-tiny at r = 16: the
    tree holds 1,032,192, the reference bills 933,888)."""
    _ported_only(cfg)
    return float(sum(rank * (din + dout) for layers in stack_layers(cfg).values()
                     for mixer, ffn, cross in layers
                     for projs in lora_layout(cfg, mixer, ffn, cross).values()
                     for din, dout in projs.values()))


def base_param_bytes(base_dtype: Optional[str], prec_bytes: float = 2.0) -> float:
    """Resident bytes per frozen-base parameter stored as ``base_dtype``:
    ``prec_bytes`` for None and "bf16", 4 for "f32".

    Quantized schemes include the amortized f32 scale overhead: int8
    carries one scale per output channel (~1/256 of params on typical
    d_in >= 256 projections), nf4 one scale per 64-element block. The
    analytic constants are deliberately slightly conservative; the
    measured ratio on real quantized trees is what ``bench_quant``
    reports against the paper-claim threshold."""
    if base_dtype in (None, "bf16"):
        return float(prec_bytes)
    if base_dtype == "f32":
        return 4.0
    if base_dtype == "int8":
        return 1.0 + 4.0 / 256.0
    if base_dtype == "nf4":
        return 0.5 + 4.0 / 64.0
    raise ValueError(f"unknown base_dtype {base_dtype!r}")


@dataclass
class CostModel(CostEstimator):
    cfg: ModelConfig
    hw: HardwareSpec
    prec_bytes: int = 2  # bf16 training
    opt_factor: float = 3.0  # AdamW: grads + 2 moments (paper's c_grad)
    act_factor: float = 12.0  # activation bytes per (token x d_model), no remat
    load_factor: float = 0.9  # paper's C
    calib: float = 1.0  # fitted efficiency scalar
    # fixed per-adapter memory overhead (optimizer workspace, allocator
    # fragmentation, autograd bookkeeping). The reference fits 1 GB to the
    # paper's §3.2 anchor (+2.2 GB for the second adapter on
    # Qwen-2.5-7B/A100-40G); the port prices its fixed cost per job instead
    # (``job_overhead_bytes``), which fits the H100's measured peaks better.
    adapter_overhead_bytes: float = 0.0
    # -- the port's memory accounting (PERF.md, "C3 fit"; REFERENCE_MEMORY
    # gives the reference's) --
    # bytes per bucket-padded LoRA parameter: the port keeps the LoRA in f32
    # with two f32 Adam moments (12 bytes, live at the cross-entropy's
    # peak) and an f32 gradient (4 more, live through the blocks'
    # backward); the reference bills prec_bytes * (1 + opt_factor)
    lora_state_bytes: float = 16.0
    # the transient bytes per padded row at the step's peak, the chunked
    # cross-entropy's backward, in units of one row's f32 logits
    # (min(seq, CE_CHUNK) x padded_vocab x 4 bytes): its f32 logits, their
    # softmax and gradient, the bf16 logits and the row's activations. 0
    # drops the term. Fitted with job_overhead_bytes on an H100
    # (chip_smoke.py's ``c3_fit``)
    logits_copies: float = 5.5
    # fixed bytes per job and device (attention decoders)
    job_overhead_bytes: float = 1.0e9
    # A decoder with SSD layers' per-job term in place of
    # job_overhead_bytes: the scan's working set in one block's backward,
    # this many f32 (rows, H, Q, Q) tensors a chunk for each SSD layer the
    # backward holds. The constant above was fitted on attention decoders'
    # jobs of 8-68 GB, where it is slack; mamba2-370m's captured sweep job
    # peaks at 2.86 GB, 0.92 GB under a price with the constant (1.32x,
    # outside C3's band). 6 prices its two measured jobs (the sweep job, the
    # launcher's f32 pack) at or above their own peaks on an H100; jamba's
    # first 8 layers' sweep job (7 SSD layers held at once) peaks at 34.49
    # GB, 0.87x a price with the constant and 1.09x one with this term. 0
    # drops the term.
    ssm_scan_copies: float = 6.0
    # An encoder-decoder's per-job term in place of job_overhead_bytes: the
    # attention's working set over the encoder's frames in one layer's
    # backward, this many f32 (rows, heads, query chunk, S_enc) tensors
    # (scores, probabilities and their gradients). With the constant,
    # whisper-tiny's captured sweep job (3 rows of 448 tokens over 1,500
    # frames; own peak 1.64 GB, the CE's backward) priced at 1.66x, outside
    # C3's band; with this term at 1.18x (H100). 0 drops the term.
    enc_attn_copies: float = 4.0
    # Padding-aware costing (beyond the paper): the packed executor
    # zero-pads every adapter to the pack's bucket rank (max rank rounded up
    # to 8), so a rank-8 adapter packed with a rank-128 one COMPUTES at rank
    # 128. With this flag the cost model charges the bucket rank, which makes
    # the DTM packer prefer rank-homogeneous packs. False = the paper's
    # padding-naive model (each adapter billed at its own rank).
    pad_aware: bool = True
    # Ragged-kernel accounting (kernels/ops.py rank segments): the kernels
    # group same-rank adapters into grid segments and compute each adapter at
    # its OWN rank (8-aligned), so mixed-rank packs stop paying bucket-
    # padding FLOPs. The autotuner's ``KernelProfile.calibrate`` sets this —
    # it supersedes pad_aware for the *time* model (memory stays bucketed:
    # the pack still allocates padded weights).
    ragged: bool = False
    # Measured LoRA-kernel rate scale (autotune feedback): the fused
    # base+delta megakernel's measured speedup over the two-pass formulation
    # on this backend. The LoRA compute term is divided by it — 1.0 = the
    # uncalibrated analytic prior (bit-identical to the pre-autotune model).
    lora_rate_scale: float = 1.0
    # Frozen-base storage scheme (kernels/quant.py): None and "bf16" keep
    # the dense ``prec_bytes`` footprint (bit-identical to the pre-quant
    # model); "f32" (``init_model``'s default, the launcher's base) prices
    # 4 bytes a parameter and computes its activations in f32, where the
    # reference prices it as ``prec_bytes``; "int8"/"nf4" shrink the
    # base-weight term of the Appendix-A memory model — and the HBM
    # weight-traffic term of the roofline — to the quantized bytes/param,
    # which is what lets the knapsack packer put more packs on a device (the
    # planner-shift this tier claims). ``kernels.quant.base_storage`` names a
    # tree's.
    base_dtype: Optional[str] = None
    # A quantized base's dense leaves and compute (``base_storage(tree,
    # dense=True)``): None or "bf16" (``prec_bytes``) or "f32" (the
    # launcher's base). The leaves ``quantize_base_params`` leaves dense --
    # the embedding, the LM head, MLA's kv_b_k / kv_b_v -- are priced at
    # it, and the activations too. Read only when ``base_dtype`` is int8 or
    # nf4.
    dense_dtype: Optional[str] = None
    # False bills every parameter of a quantized base at the scheme's bytes,
    # the dense leaves too (the reference's accounting, REFERENCE_MEMORY)
    price_dense_leaves: bool = True

    @staticmethod
    def bucket_rank(configs: Sequence[LoraConfig]) -> int:
        r = max((c.rank for c in configs), default=8)
        return max(8, (r + 7) // 8 * 8)

    def _eff_rank(self, c: LoraConfig, configs: Sequence[LoraConfig]) -> int:
        if self.ragged:
            return max(8, (c.rank + 7) // 8 * 8)
        return self.bucket_rank(configs) if self.pad_aware else c.rank

    # ---------------- memory (Appendix A) ----------------

    def base_bytes_per_param(self) -> float:
        """Resident bytes per frozen-base parameter under ``base_dtype``
        (:func:`base_param_bytes`)."""
        return base_param_bytes(self.base_dtype, self.prec_bytes)

    def compute_dtype(self) -> Optional[str]:
        """The dtype the base computes in: a quantized base's
        ``dense_dtype``, else its own storage."""
        return self.dense_dtype if self.base_dtype in MODES else self.base_dtype

    def base_weight_bytes(self) -> float:
        n = model_param_count(self.cfg)
        if self.base_dtype not in MODES or not self.price_dense_leaves:
            return n * self.base_bytes_per_param()
        q = quantized_param_count(self.cfg, self.base_dtype)
        return (q * self.base_bytes_per_param()
                + (n - q) * base_param_bytes(self.dense_dtype, self.prec_bytes))

    def base_act_bytes(self, total_batch: int, seq: int) -> float:
        # an f32 base (or a quantized one on f32 dense leaves) computes in
        # f32, any other in prec_bytes
        elem = 4.0 if self.compute_dtype() == "f32" else self.prec_bytes
        return self.act_factor * total_batch * seq * self.cfg.d_model * elem

    def logits_bytes(self, rows: int, seq: int) -> float:
        """The cross-entropy's f32 logits workspace for ``rows`` rows."""
        if not self.logits_copies:
            return 0.0
        return (self.logits_copies * rows * min(seq, CE_CHUNK)
                * self.cfg.padded_vocab * 4.0)

    def lora_bytes(self, c: LoraConfig, seq: Optional[int] = None) -> float:
        """One adapter's bytes: its state, activations, its rows' logits
        workspace and ``adapter_overhead_bytes``."""
        seq = seq or c.seq_len
        state = lora_param_count(self.cfg, c.rank) * self.lora_state_bytes
        act = c.batch_size * seq * c.rank * self.prec_bytes * (
            self.cfg.n_layers + self.cfg.encoder_layers
        )
        return (state + act + self.logits_bytes(c.batch_size, seq)
                + self.adapter_overhead_bytes)

    def job_mem_bytes(self, configs: Sequence[LoraConfig], d: int, seq: int) -> float:
        total_batch = sum(c.batch_size for c in configs)
        base = self.base_weight_bytes() + self.base_act_bytes(total_batch, seq)
        # the pack pads every adapter to its largest batch: the padding rows'
        # logits (each adapter's own rows are in its lora_bytes)
        padded = len(configs) * max((c.batch_size for c in configs), default=0)
        base += self.logits_bytes(padded - total_batch, seq)
        if self.pad_aware:
            import dataclasses as _dc

            rb = self.bucket_rank(configs)
            loras = sum(
                self.lora_bytes(_dc.replace(c, rank=rb), seq) for c in configs
            )
        else:
            loras = sum(self.lora_bytes(c, seq) for c in configs)
        return (base + loras) / d + self.job_fixed_bytes(padded, seq)

    def job_fixed_bytes(self, rows: int, seq: int) -> float:
        """The per-job term of ``job_mem_bytes``: ``job_overhead_bytes``,
        or for a decoder with SSD layers the scan's working set of ``rows``
        padded rows (``ssm_scan_copies`` f32 (rows, H, Q, Q) tensors per
        chunk of Q) for each SSD layer the backward holds at once
        (``_live_mixers``: mamba2's block is one layer; jamba's first 8
        layers stack as a block of 6 and a remainder of 2, 7 SSD layers),
        or for an encoder-decoder the attention's working set over the
        encoder's frames (``enc_attn_copies`` f32 (rows, H, min(S_enc,
        ATTN_CHUNK), S_enc) tensors: one query chunk's scores at a time)."""
        if self.cfg.is_encdec:
            s_enc, a = self.cfg.encoder_seq_len, self.cfg.attention
            return self.enc_attn_copies * rows * a.n_heads * min(s_enc, ATTN_CHUNK) * s_enc * 4.0
        n_ssd = _live_mixers(self.cfg).count("ssm")
        if not n_ssd:
            return self.job_overhead_bytes
        s = self.cfg.ssm
        q = s.chunk_size
        per_chunk = rows * s.n_heads(self.cfg.d_model) * q * q * 4.0
        return self.ssm_scan_copies * per_chunk * -(-seq // q) * n_ssd

    def fits(self, configs: Sequence[LoraConfig], d: int, seq: int) -> bool:
        return self.job_mem_bytes(configs, d, seq) <= (
            self.load_factor * self.hw.mem_bytes
        )

    def min_degree(self, configs: Sequence[LoraConfig], seq: int) -> Optional[int]:
        d = 1
        while d <= self.hw.n_devices:
            if self.fits(configs, d, seq):
                return d
            d *= 2
        return None

    # ---------------- time (three-term roofline) ----------------

    def iter_time(self, configs: Sequence[LoraConfig], d: int, seq: int) -> float:
        """Seconds per packed training iteration on d device units."""
        tokens = sum(c.batch_size for c in configs) * seq
        n_active = active_param_count(self.cfg)
        # frozen base: fwd 2ND + act-grad bwd 2ND = 4ND
        base_flops = 4.0 * n_active * tokens
        # padding-aware: each adapter computes at the pack's bucket rank
        lora_flops = sum(
            6.0 * lora_param_count(self.cfg, self._eff_rank(c, configs))
            * c.batch_size * seq
            for c in configs
        )
        # per-device GEMM granularity shrinks with TP degree: tokens don't
        # split under TP but each device's slice of every GEMM does, so the
        # efficiency argument is tokens/d (penalizes Max-GPU, §7.2.1).
        eff = self.hw.eff(tokens / d)
        # lora_rate_scale is the autotuner's measured fused-kernel speedup
        # (1.0 = uncalibrated; division by 1.0 is bit-exact, so the default
        # model is unchanged)
        compute_t = (base_flops + lora_flops / self.lora_rate_scale) / (
            d * self.hw.peak_flops * eff
        )
        # weight traffic: weights read in fwd + bwd; adapters updated
        wbytes = 2.0 * self.base_weight_bytes()
        wbytes += sum(
            (2.0 + 2.0 * self.opt_factor)
            * lora_param_count(self.cfg, c.rank)
            * self.prec_bytes
            for c in configs
        )
        act_bytes = 2.0 * self.base_act_bytes(
            sum(c.batch_size for c in configs), seq
        )
        mem_t = (wbytes + act_bytes) / (d * self.hw.hbm_bw)
        # TP collectives: 2 all-reduces of (tokens, d_model) per layer, ring
        coll_t = 0.0
        if d > 1:
            layer_count = self.cfg.n_layers + self.cfg.encoder_layers
            coll_bytes = (
                4.0  # fwd+bwd, attn+mlp
                * layer_count
                * tokens
                * self.cfg.d_model
                * self.prec_bytes
                * 2.0
                * (d - 1)
                / d
            )
            coll_t = coll_bytes / (d * self.hw.link_bw)
        fixed_t = self.hw.layer_overhead * (
            self.cfg.n_layers + self.cfg.encoder_layers
        )
        return (max(compute_t, mem_t) + coll_t + fixed_t) * self.calib

    def iter_time_sequential(
        self, configs: Sequence[LoraConfig], d: int, seq: int
    ) -> float:
        """Naive packed execution (paper §5.1 / Fig. 6 'Sequential PLoRA'):
        the BASE pass is batched over all adapters' inputs, but each adapter's
        LoRA computation runs as its own small kernel sequence — per-adapter
        launch overhead plus LoRA GEMMs at single-adapter efficiency.
        (Calls CostModel.iter_time explicitly so subclasses that alias
        iter_time -> iter_time_sequential don't recurse.)"""
        t = CostModel.iter_time(self, configs, d, seq)
        for c in configs:
            tokens_k = c.batch_size * seq
            lora_flops = 6.0 * lora_param_count(self.cfg, c.rank) * tokens_k
            t += self.calib * (
                self.hw.seq_adapter_overhead
                + lora_flops / (d * self.hw.peak_flops * self.hw.eff(tokens_k / d))
            )
        return t

    # per-job fixed cost: base-checkpoint load + process/compile warmup.
    # Min-GPU pays it once per CONFIG (120x); packed jobs amortize it —
    # this is the planner-only gain visible in the Fig. 6 ablation.
    setup_time: float = 60.0

    # job_time / job_time_residual / adapter_finish_offset / throughput are
    # inherited from CostEstimator, derived from iter_time + setup_time.

    # ---------------- calibration ----------------

    def calibrate(self, measured_iter_time: float, configs, d: int, seq: int):
        """Fit the time scalar so predicted == measured (one-point fit from
        ~10 profiled iterations, as in the paper)."""
        pred = self.iter_time(configs, d, seq)
        self.calib = self.calib * measured_iter_time / pred
        return self.calib
