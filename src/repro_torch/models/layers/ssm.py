"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

Chunked SSD scan: within a chunk the contribution is a decay-masked
quadratic form (the "attention-like" dual); across chunks a Python loop
over static chunk shapes carries the (H, P, N) state (the reference's
``lax.scan``): O(S) time, O(S x chunk) working set, exact with respect to
the step recurrence (``ssd_reference``). No host sync anywhere, so a CUDA
graph captures it.

The scan, the depthwise causal conv and the gated RMSNorm are plain ``jnp``
in the reference, not Pallas, so they are plain PyTorch here. ``zx`` and
``out`` go through ``lora_linear`` (the LoRA targets "ssm_in" and
"ssm_out"), so through the packed and fused kernels; ``bc`` and ``dt`` are
plain products. Single-group (G=1) B/C.

Between the projections the port computes in f32 whatever the base's dtype:
the conv, the scan's epilogue (y + D x) and the gated norm, with one cast to
the compute dtype before ``out`` (the reference rounds each to the compute
dtype). With the stack's f32 residual stream (``transformer.apply_layer``)
this narrows the spread of a bf16 mamba2-370m at 48 layers: two
computations that differ only in a summation order inside the LoRA
products (the kernels against their plain versions) drift apart by more
than 5 % of max |logit| with the reference's roundings (``PERF.md``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSM_TARGETS, SSMConfig, ssm_projections
from repro_torch.core.adapter import init_lora_pair
from repro_torch.core.packed_lora import lora_linear
from repro_torch.models.layers.common import apply_norm, init_linear


def init_ssm(gen, d_model: int, scfg: SSMConfig, meta, targets, dtype=torch.float32, device=None):
    """The reference's SSD parameters (``ssm.py:25-52``): zx, bc, dt (no
    bias), dt_bias 0, conv_w N(0, 0.04), conv_b 0, a_log log(linspace(1,
    16, H)), d_skip 1, the gated norm's scale 1, out; then LoRA pairs on
    ``zx`` and ``out`` for "ssm_in" and "ssm_out"."""
    if scfg.n_groups != 1:
        raise ValueError("single-group SSD only")
    shapes = ssm_projections(scfg, d_model)
    di, h = scfg.d_inner(d_model), scfg.n_heads(d_model)
    conv_ch = di + 2 * scfg.d_state
    params = {nm: init_linear(gen, *shapes[nm], False, dtype, device) for nm in ("zx", "bc", "dt")}
    params["dt_bias"] = torch.zeros((h,), dtype=dtype, device=device)
    conv_w = torch.randn((scfg.d_conv, conv_ch), generator=gen, device=device) * 0.2
    params["conv_w"] = conv_w.to(dtype)
    params["conv_b"] = torch.zeros((conv_ch,), dtype=dtype, device=device)
    params["a_log"] = torch.log(torch.linspace(1.0, 16.0, h, device=device)).to(dtype)
    params["d_skip"] = torch.ones((h,), dtype=dtype, device=device)
    params["norm"] = {"scale": torch.ones((di,), dtype=dtype, device=device)}
    params["out"] = init_linear(gen, *shapes["out"], False, dtype, device)
    lora = {}
    if meta is not None:
        for t, nm in SSM_TARGETS.items():
            if t in targets:
                lora[nm] = init_lora_pair(gen, meta, *shapes[nm], dtype, device)
    return params, lora


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (NB, S, C); w: (K, C); zero left padding."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i : i + s] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _ssd_scan(xs, b, c, dt, a_log, chunk: int, state0=None):
    """Chunked SSD. xs: (NB, S, H, P); b/c: (NB, S, N); dt: (NB, S, H)
    (after the softplus). ``state0`` (NB, H, P, N) resumes the recurrence;
    None starts from zeros. Returns (y (NB, S, H, P) in xs's dtype, the
    final state (NB, H, P, N) in f32).

    The reference's ``lax.scan`` body, split by what depends on the carried
    state: the intra-chunk dual and each chunk's own state contribution are
    computed for every chunk at once; only the state's pass across chunks
    is a Python loop (two products a chunk). A sequence that is not a
    multiple of ``chunk`` is padded with dt = 0 (a decay of 1 and no
    input), so the final state ignores the padding. The intra-chunk decays
    are masked with -inf above the diagonal before the exp: there the
    log-decay difference is positive and large, and exp first would give
    inf * 0 = NaN. Products in f32."""
    nb, s, h, p = xs.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())  # (H,), negative
    if s % chunk:
        pad = chunk - s % chunk
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = xs.shape[1] // chunk
    xq = xs.float().reshape(nb, nc, chunk, h, p).transpose(2, 3)  # (NB, nc, H, Q, P)
    bq = b.float().reshape(nb, nc, chunk, n)  # (NB, nc, Q, N)
    cq = c.float().reshape(nb, nc, chunk, n)
    dtq = dt.float().reshape(nb, nc, chunk, h).transpose(2, 3)  # (NB, nc, H, Q)
    cum = torch.cumsum(dtq * a[:, None], dim=-1)  # inclusive log-decay
    # intra-chunk quadratic dual, (NB, nc, H, i, j)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=xs.device).tril()  # j <= i
    l_mat = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :], float("-inf")))
    m = (cq @ bq.transpose(-1, -2))[:, :, None] * l_mat * dtq[..., None, :]
    y = m @ xq
    # each chunk's contribution to the state after it, from a zero state
    last = cum[..., -1:]  # (NB, nc, H, 1)
    w = dtq * torch.exp(last - cum)  # (NB, nc, H, Q)
    own = torch.einsum("bchq,bchqp,bcqn->bchpn", w, xq, bq)  # (NB, nc, H, P, N)
    decay = torch.exp(last)[..., None]  # (NB, nc, H, 1, 1)
    state = (torch.zeros((nb, h, p, n), dtype=torch.float32, device=xs.device)
             if state0 is None else state0.float())
    entering = []  # the state each chunk starts from
    for k in range(nc):
        entering.append(state)
        state = state * decay[:, k] + own[:, k]
    # inter-chunk: y_i += exp(cum_i) * C_i . state entering the chunk
    y_inter = torch.einsum("bcqn,bchpn->bchqp", cq, torch.stack(entering, 1))
    y = y + y_inter * torch.exp(cum)[..., None]
    y = y.transpose(2, 3).reshape(nb, nc * chunk, h, p)[:, :s]
    return y.to(xs.dtype), state


def _in_proj(params, lo, scales, x, scfg: SSMConfig, n_pack, kcfg):
    """z (NB, S, di), the conv's input [x | B | C] (NB, S, C) and the raw
    step dt (NB, S, H)."""
    di = scfg.d_inner(x.shape[-1])
    zx = lora_linear(x, params["zx"], lo.get("zx"), scales, n_pack, kcfg=kcfg)
    bc = x @ params["bc"]["w"].to(x.dtype)
    dt_raw = x @ params["dt"]["w"].to(x.dtype) + params["dt_bias"].to(x.dtype)
    return zx[..., :di], torch.cat([zx[..., di:], bc], dim=-1), dt_raw


def _out_proj(params, lo, scales, y, z, n_pack, kcfg):
    """The gated RMSNorm in f32, norm(y * silu(z)), cast to z's dtype (the
    compute dtype), then ``out``."""
    y = apply_norm(params["norm"], y.float() * F.silu(z.float()), "rmsnorm").to(z.dtype)
    return lora_linear(y, params["out"], lo.get("out"), scales, n_pack, kcfg=kcfg)


def apply_ssm(params, lora, scales, x, *, scfg: SSMConfig, n_pack: int = 1,
              return_state: bool = False, kcfg=None):
    """Full-sequence SSD block. x: (NB, S, d). Returns (out, cache or
    None); with ``return_state`` the decode cache: the conv window, the last
    ``d_conv - 1`` rows of the conv's unpadded input (zero rows ahead of a
    shorter sequence), and the scan's final state (f32)."""
    lo = lora or {}
    nb, s, d = x.shape
    di, h, n = scfg.d_inner(d), scfg.n_heads(d), scfg.d_state
    z, conv_in, dt_raw = _in_proj(params, lo, scales, x, scfg, n_pack, kcfg)
    conv = F.silu(_causal_conv(conv_in.float(), params["conv_w"], params["conv_b"]))
    xs, b, c = conv[..., :di], conv[..., di : di + n], conv[..., di + n :]
    dt = F.softplus(dt_raw.float())
    xh = xs.reshape(nb, s, h, -1)
    y, state = _ssd_scan(xh, b, c, dt, params["a_log"], scfg.chunk_size)
    y = y + params["d_skip"].float()[None, None, :, None] * xh
    out = _out_proj(params, lo, scales, y.reshape(nb, s, di), z, n_pack, kcfg)
    cache = None
    if return_state:
        k = scfg.d_conv - 1
        cache = {"conv": F.pad(conv_in[:, -k:], (0, 0, max(0, k - s), 0)), "state": state}
    return out, cache


def apply_ssm_chunk(params, lora, scales, x, cache, *, scfg: SSMConfig, n_pack: int = 1,
                    kcfg=None):
    """One chunk of a chunk-resumable prefill (the reference's
    ``ssm.py:178-219``). x: (NB, S, d), S > 1; cache: {conv (NB, K-1, C),
    state (NB, H, P, N)} as ``apply_ssm(return_state=True)`` or this leaves
    them, updated in place (``copy_``, as ``apply_ssm_decode``) and
    returned. The conv window is replayed from the cached K-1 rows (put
    ahead of the chunk's conv input; the first K-1 outputs, over the zero
    padding, are dropped) and the scan resumes from the cached state
    (``_ssd_scan(state0=)``), with ``apply_ssm``'s promotions: the conv in
    f32, the state f32. When every resume falls on a multiple of
    ``scfg.chunk_size`` the chunks reproduce ``apply_ssm`` bit for bit on
    the CPU's f32 path (``serve.decode.align_prefill_chunk`` rounds the
    engine's chunk up to it); off that grid the scan regroups its sums."""
    lo = lora or {}
    nb, s, d = x.shape
    di, h, n, k = scfg.d_inner(d), scfg.n_heads(d), scfg.d_state, scfg.d_conv
    z, conv_in, dt_raw = _in_proj(params, lo, scales, x, scfg, n_pack, kcfg)
    win = torch.cat([cache["conv"].float(), conv_in.float()], dim=1)  # (NB, K-1+S, C)
    conv = F.silu(_causal_conv(win, params["conv_w"], params["conv_b"])[:, k - 1 :])
    xs, b, c = conv[..., :di], conv[..., di : di + n], conv[..., di + n :]
    dt = F.softplus(dt_raw.float())
    xh = xs.reshape(nb, s, h, -1)
    y, state = _ssd_scan(xh, b, c, dt, params["a_log"], scfg.chunk_size, state0=cache["state"])
    y = y + params["d_skip"].float()[None, None, :, None] * xh
    out = _out_proj(params, lo, scales, y.reshape(nb, s, di), z, n_pack, kcfg)
    cache["conv"].copy_(win[:, -(k - 1) :])
    cache["state"].copy_(state)
    return out, cache


def apply_ssm_decode(params, lora, scales, x, cache, *, scfg: SSMConfig, n_pack: int = 1,
                     kcfg=None):
    """One-token step. x: (NB, 1, d); cache: {conv (NB, K-1, C), state (NB,
    H, P, N)}, updated in place (``copy_`` into the given tensors, which
    may be views of a stacked cache) and returned. The conv and the state
    step run in the cache's dtype promoted with x's (f32 for the f32 cache
    leaves that ``init_ssm_cache`` makes), as the reference promotes."""
    lo = lora or {}
    nb, _, d = x.shape
    z, conv_in, dt_raw = _in_proj(params, lo, scales, x, scfg, n_pack, kcfg)
    y = _ssd_step(params, conv_in, dt_raw, cache, scfg)
    out = _out_proj(params, lo, scales, y.reshape(nb, 1, -1), z, n_pack, kcfg)
    return out, cache


def _ssd_step(params, conv_in, dt_raw, cache, scfg: SSMConfig):
    """The decode step's conv and recurrence: one token's conv over the
    cached window, the state's decay and update, y = C . state + D x.
    Writes the new window and state into ``cache``; returns y (NB, H, P)."""
    nb, n = conv_in.shape[0], scfg.d_state
    di = conv_in.shape[-1] - 2 * n
    h = di // scfg.head_dim
    wdt = torch.promote_types(cache["conv"].dtype, conv_in.dtype)
    win = torch.cat([cache["conv"].to(wdt), conv_in.to(wdt)], dim=1)  # (NB, K, C)
    conv = torch.einsum("bkc,kc->bc", win, params["conv_w"].to(wdt))
    conv = F.silu(conv + params["conv_b"].to(wdt))
    xs1, b1, c1 = conv[..., :di], conv[..., di : di + n].float(), conv[..., di + n :].float()
    dt = F.softplus(dt_raw.float())[:, 0]  # (NB, H)
    a = -torch.exp(params["a_log"].float())
    xh = xs1.reshape(nb, h, -1).float()
    state = cache["state"].float() * torch.exp(dt * a)[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, b1, xh)
    y = torch.einsum("bn,bhpn->bhp", c1, state) + params["d_skip"].float()[None, :, None] * xh
    cache["conv"].copy_(win[:, 1:])
    cache["state"].copy_(state)
    return y


def init_ssm_cache(nb: int, d_model: int, scfg: SSMConfig, dtype=torch.float32, device=None):
    """{conv (NB, K-1, C) in ``dtype``, state (NB, H, P, N) in f32}; the
    stack allocates both in f32 whatever its cache dtype (the reference's
    ``transformer.py:462-463``)."""
    conv_ch = scfg.d_inner(d_model) + 2 * scfg.n_groups * scfg.d_state
    return {
        "conv": torch.zeros((nb, scfg.d_conv - 1, conv_ch), dtype=dtype, device=device),
        "state": torch.zeros((nb, scfg.n_heads(d_model), scfg.head_dim, scfg.d_state),
                             dtype=torch.float32, device=device),
    }


def ssd_reference(xs, b, c, dt, a_log):
    """The step recurrence (tests only); the same inputs as ``_ssd_scan``.
    Returns y (NB, S, H, P) in f32."""
    nb, s, h, p = xs.shape
    a = -torch.exp(a_log.float())
    state = torch.zeros((nb, h, p, b.shape[-1]), dtype=torch.float32, device=xs.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()
        state = state * torch.exp(dtt * a)[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dtt, b[:, t].float(), xs[:, t].float())
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t].float(), state))
    return torch.stack(ys, dim=1)
