"""Mixture-of-experts FFN: the dense path (the exact oracle) and the
capacity-bounded dispatch with every expert local (the port of
``repro/models/layers/moe.py``).

``impl="dense"`` computes every expert for every token and combines with
the top-k gates: exact, E / top_k times the routed work (grok-1's path).

``impl="ep"`` routes each (token, k) pair to a slot of its expert's buffer
of ``capacity`` rows with a stable sort: within an expert, earlier tokens
take the earlier slots and pairs past the capacity are dropped (they add
nothing). The experts run as three batched products over the (E, C, d)
buffer, and the outputs are gathered back, gate-weighted, per token. The
reference runs this path inside ``shard_map`` over an expert axis; on one
device every expert is local (``e_lo = 0``) and there is no psum.

Dispatch and combine are partial permutations (each pair fills at most one
slot), so the port writes both as gathers whose backward is the opposite
gather followed by a sum over k (``_Dispatch``, ``_Combine``): no
scatter-add, no atomic add, so a step's gradients are the same bits run to
run, as the sweep's "captured equals eager" check and the recompute of a
checkpointed block need. The reference scatter-adds (``.at[].add``): the
sums over a token's k contributions run in another order. Every index is
built on the device with static shapes (no host read), so the step can be
captured in a CUDA graph.

The capacity couples the tokens of a call: in a pack, the rows of every
adapter share each expert's slots, and the last rows lose the most pairs
when an expert overflows; the aux loss is one scalar over the whole call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers.common import init_linear


def init_moe(gen, d_model: int, mcfg: MoEConfig, dtype=torch.float32, device=None) -> dict:
    """The router (d, E) in f32 whatever ``dtype`` (its top-k choice reads
    it, as in the reference), then the experts' SwiGLU weights w_gate,
    w_up (E, d, f) ~ N(0, 1/d) and w_down (E, f, d) ~ N(0, 1/f), in that
    order."""
    e, f = mcfg.n_experts, mcfg.d_expert

    def draw(shape, std):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * std).to(dtype)

    return {
        "router": init_linear(gen, d_model, e, False, torch.float32, device),
        "w_gate": draw((e, d_model, f), d_model ** -0.5),
        "w_up": draw((e, d_model, f), d_model ** -0.5),
        "w_down": draw((e, f, d_model), f ** -0.5),
    }


def _router(x, params, mcfg: MoEConfig):
    """x (T, d) -> (gates (T, k) renormalized, idx (T, k), aux): f32 logits,
    softmax, top-k, the gates over their sum + 1e-9, and the Switch
    load-balance loss E * sum_e mean_prob_e * routed_share_e."""
    logits = x.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, mcfg.top_k, dim=-1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    e = mcfg.n_experts
    me = probs.mean(0)
    flat = idx.reshape(-1)
    # integer counts of 1.0s: exact in any order
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x.device)) / (flat.numel() + 1e-9)
    return gates, idx, e * torch.sum(me * ce)


def _expert_ffn(w_gate, w_up, w_down, h):
    """h (E, C, d) -> (E, C, d): SwiGLU experts as batched products."""
    g = torch.bmm(h, w_gate.to(h.dtype))
    u = torch.bmm(h, w_up.to(h.dtype))
    return torch.bmm(F.silu(g) * u, w_down.to(h.dtype))


def _moe_dense(params, x, mcfg: MoEConfig, chunk: int = 1024):
    """Every expert on every token, combined with the top-k gates (a (T, E)
    matrix, zero off the top k); over chunks of ``chunk`` tokens, each
    checkpointed when grad mode is on. The router reads ``x`` as given, the
    experts ``x`` in their weights' dtype; the combine sums in f32. Returns
    (y (T, d) f32, aux)."""
    t = x.shape[0]
    gates, idx, aux = _router(x, params, mcfg)
    x = x.to(params["w_gate"].dtype)
    comb = torch.zeros((t, mcfg.n_experts), dtype=torch.float32, device=x.device).scatter(
        1, idx, gates)

    def one_chunk(xc, cc):  # (c, d), (c, E)
        hc = xc.unsqueeze(0).expand(mcfg.n_experts, -1, -1)
        g = torch.bmm(hc, params["w_gate"].to(xc.dtype))
        u = torch.bmm(hc, params["w_up"].to(xc.dtype))
        ye = torch.bmm(F.silu(g) * u, params["w_down"].to(xc.dtype))  # (E, c, d)
        return torch.einsum("ecd,ce->cd", ye.float(), cc)

    if t <= chunk:
        return one_chunk(x, comb), aux
    remat = torch.is_grad_enabled()
    ys = []
    for lo in range(0, t, chunk):
        xc, cc = x[lo:lo + chunk], comb[lo:lo + chunk]
        ys.append(checkpoint(one_chunk, xc, cc, use_reentrant=False, preserve_rng_state=False)
                  if remat else one_chunk(xc, cc))
    return torch.cat(ys), aux


class _Dispatch(torch.autograd.Function):
    """h[s] = x[tok[s]] where slot s is filled, else 0 (S = E * C slots).
    Backward: each (token, k) pair reads the gradient of its slot (a zero
    row when it was dropped), summed over k: gathers only."""

    @staticmethod
    def forward(ctx, x, tok, filled, slot_of_pair, k: int):
        ctx.save_for_backward(slot_of_pair)
        ctx.k = k
        return torch.where(filled[:, None], x.index_select(0, tok), x.new_zeros(()))

    @staticmethod
    def backward(ctx, g):
        (slot_of_pair,) = ctx.saved_tensors
        gp = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        gx = gp.index_select(0, slot_of_pair).view(-1, ctx.k, g.shape[1]).sum(1)
        return gx, None, None, None, None


class _Combine(torch.autograd.Function):
    """y[t] = sum_k w[t, k] * y_e[slot_of_pair[t, k]] (a dropped pair's slot
    is the zero row past the buffer), in w's dtype (f32: the gates are not
    rounded to the experts' dtype, nor the sum). Backward: each filled slot
    reads its token's gradient times its pair's weight; each pair's weight
    the dot of its token's gradient with its slot's output: gathers only."""

    @staticmethod
    def forward(ctx, y_e, w, slot_of_pair, tok, filled, pair_of_slot):
        d = y_e.shape[1]
        yp = torch.cat([y_e, y_e.new_zeros((1, d))])
        g = yp.index_select(0, slot_of_pair).view(w.shape[0], w.shape[1], d)
        ctx.save_for_backward(y_e, w, slot_of_pair, tok, filled, pair_of_slot)
        return (g * w[..., None]).sum(1)

    @staticmethod
    def backward(ctx, gy):
        y_e, w, slot_of_pair, tok, filled, pair_of_slot = ctx.saved_tensors
        d = y_e.shape[1]
        w_slot = w.reshape(-1).index_select(0, pair_of_slot)
        gy_e = torch.where(filled[:, None], gy.index_select(0, tok) * w_slot[:, None],
                           gy.new_zeros(()))
        yp = torch.cat([y_e, y_e.new_zeros((1, d))])
        g = yp.index_select(0, slot_of_pair).view(w.shape[0], w.shape[1], d)
        gw = (gy[:, None, :] * g).sum(-1)
        return gy_e.to(y_e.dtype), gw.to(w.dtype), None, None, None, None


def dispatch_plan(idx, n_experts: int, capacity: int, e_lo: int = 0, e_local=None):
    """The dispatch of ``idx`` (T, k) to the ``e_local`` experts from
    ``e_lo`` (all E by default), ``capacity`` slots each, as the reference's
    stable sort makes it, with static shapes and no host read. Returns
    (slot_of_pair (T*k,): a pair's slot, or S = e_local * capacity when it
    is dropped or its expert is not local; tok (S,): each slot's token;
    filled (S,); pair_of_slot (S,): each slot's pair, 0 where empty)."""
    e_local = n_experts if e_local is None else e_local
    t, k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)
    n = t * k
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros((n_experts,), dtype=torch.int64, device=dev).index_add_(
        0, flat_e, torch.ones((n,), dtype=torch.int64, device=dev))
    starts = torch.cumsum(counts, 0) - counts
    se = flat_e.index_select(0, order)
    pos = torch.arange(n, device=dev) - starts.index_select(0, se)
    local = (se >= e_lo) & (se < e_lo + e_local) & (pos < capacity)
    slot_sorted = torch.where(local, (se - e_lo) * capacity + pos, e_local * capacity)
    # a permutation's inverse: every index written once
    slot_of_pair = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    j = torch.arange(capacity, device=dev)
    counts, starts = counts[e_lo:e_lo + e_local], starts[e_lo:e_lo + e_local]
    filled = (j[None, :] < counts[:, None]).reshape(-1)
    src = (starts[:, None] + j[None, :]).reshape(-1).clamp_(max=n - 1)
    pair_of_slot = torch.where(filled, order.index_select(0, src), 0)
    return slot_of_pair, torch.div(pair_of_slot, k, rounding_mode="floor"), filled, pair_of_slot


def _moe_ep_local(params, x, mcfg: MoEConfig, e_lo: int, e_local: int, capacity: int):
    """The experts [e_lo, e_lo + e_local) that ``params`` holds, for every
    token of ``x`` (on one device: e_lo = 0, e_local = E): route, dispatch
    to (e_local, capacity, d), run the experts, combine. The router reads
    ``x`` as given (an f32 stream's f32 norm output: no rounding moves a
    near-tie), the experts ``x`` in their weights' dtype; the combine sums
    the gate-weighted outputs in f32. Returns (y (T, d) f32: these experts'
    part, aux)."""
    t, d = x.shape
    k = mcfg.top_k
    gates, idx, aux = _router(x, params, mcfg)
    x = x.to(params["w_gate"].dtype)
    slot_of_pair, tok, filled, pair_of_slot = dispatch_plan(idx, mcfg.n_experts, capacity,
                                                            e_lo, e_local)
    kept = (slot_of_pair < e_local * capacity).view(t, k)
    h = _Dispatch.apply(x, tok, filled, slot_of_pair, k).view(e_local, capacity, d)
    y_e = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], h)
    w = gates * kept
    y = _Combine.apply(y_e.reshape(e_local * capacity, d), w, slot_of_pair, tok, filled,
                       pair_of_slot)
    return y, aux


def moe_capacity(t: int, mcfg: MoEConfig) -> int:
    """Slots per expert for ``t`` tokens: t * k / E * capacity_factor + 1,
    at least 8 and at most t."""
    c = int(t * mcfg.top_k / mcfg.n_experts * mcfg.capacity_factor) + 1
    return max(8, min(c, t))


def apply_moe(params, x, mcfg: MoEConfig):
    """x (NB, S, d) -> (y (NB, S, d) f32, aux): the NB * S tokens of the
    call routed together."""
    nb, s, d = x.shape
    xt = x.reshape(nb * s, d)
    if mcfg.impl == "dense":
        y, aux = _moe_dense(params, xt, mcfg)
    else:
        y, aux = _moe_ep_local(params, xt, mcfg, 0, mcfg.n_experts, moe_capacity(nb * s, mcfg))
    return y.reshape(nb, s, d), aux
