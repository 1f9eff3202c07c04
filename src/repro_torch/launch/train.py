"""Training launcher: train one pack of LoRA configurations on one device
through the cluster subsystem (the port of the single-host path of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen25-7b \\
      --reduced --steps 20 --ranks 8,16 --lrs 1e-3,5e-4 --seq 32

The pack trains on a one-device slice of a ``DevicePool`` through
``SliceExecutor.train_pack``: on CUDA as one captured CUDA graph of the
step, on the CPU eagerly. It runs on CUDA unless ``--device`` says
otherwise (``--device cpu`` for a run without a card; with no device given
and no CUDA it raises). The model is initialized
from a seed in f32, as the reference's launcher does; with ``--quant
int8|nf4`` its projections are quantized layer by layer as they are drawn
(``init_model(..., quant=)``), so a model whose dense base does not fit the
card (``--arch command-r-35b``) still builds. ``--arch qwen3-moe-30b-a3b``
does not fit one card this way: its f32 base is 122 GB, and ``--quant``
leaves the experts (29.0 B of its 30.53 B parameters) dense, as the
reference's quantizer does; it runs here at ``--reduced`` size, and so
does ``--arch jamba-v0.1-52b`` (an f32 base of 206 GB, ~97 GB as int8
with its experts dense).

Ported flags besides the pack's: ``--impl``/``--quant``/``--remat`` (the
kernel policy), ``--pool`` (save each adapter), ``--save-state`` /
``--resume-state`` / ``--state-id`` (the whole packed state; a resumed run
continues each adapter's data stream where it stopped, so it equals an
unbroken run), ``--hw`` (the cost-model prior of the plan-vs-measured
table, default ``h100``), ``--profile-in`` / ``--profile-out`` (the
observation store), ``--autotune-cache`` (``kernels/autotune.py``: sweep the
fused kernel's K split at the pack's projection shapes, keep the result in a
JSON cache, run the tuned split and calibrate the cost-model prior with the
measured fused rate; it runs the fused tier), ``--trace-out`` (a Chrome
trace of the autotuner's and the executor's spans) and ``--metrics-out``
(the metrics registry as JSON). The reference's other flags wait for the
port's multi-host and sharded slices, and raise if given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cluster import DevicePool, SliceExecutor
from repro_torch.configs.base import LoraConfig, get_config, list_archs, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import extract_adapter
from repro_torch.kernels.ops import IMPLS, REMATS
from repro_torch.kernels.quant import base_storage
from repro_torch.models.model import init_model
from repro_torch.obs import NULL_TRACER, Tracer
from repro_torch.sched.cost_model import PRESETS, CostModel
from repro_torch.sched.profile import ObservationStore, ProfiledCostModel
from repro_torch.train.checkpoint import CheckpointPool

# the reference launcher's flags that wait for the port's multi-host and
# sharded slices
NOT_PORTED = {
    "--mesh": "value", "--hosts": "value", "--devices-per-host": "value",
    "--host-classes": "value", "--heartbeat": "value", "--drain-after": "value",
    "--join-after": "value", "--fsdp": "flag", "--seq-parallel": "flag",
}


def _floats(s):
    return [float(x) for x in s.split(",")]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen25-7b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", help="test-size variant of the arch")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ranks", default="8,16")
    ap.add_argument("--lrs", default="1e-3,5e-4")
    ap.add_argument("--alphas", default=None, help="default: 2*rank")
    ap.add_argument("--batch-sizes", default=None, help="default: 1 each")
    ap.add_argument("--impl", default=None, choices=IMPLS,
                    help="packed-LoRA kernel path (kernels/ops.py); default 'auto'")
    ap.add_argument("--quant", default="none", choices=["none", "int8", "nf4"],
                    help="store the frozen base's projections quantized (kernels/quant.py)")
    ap.add_argument("--remat", default=None, choices=REMATS,
                    help="backward xA policy of the LoRA kernels (default 'save')")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--pool", default=None, help="checkpoint pool dir")
    ap.add_argument("--save-state", action="store_true",
                    help="checkpoint the packed state (adapters, optimizer, step counts) "
                         "into --pool at the end")
    ap.add_argument("--resume-state", action="store_true",
                    help="resume a packed run saved with --save-state (same arch and ranks)")
    ap.add_argument("--state-id", default=None, help="packed-state id in the pool (default: arch)")
    ap.add_argument("--hw", default="h100", choices=sorted(PRESETS),
                    help="hardware prior of the plan-vs-measured table")
    ap.add_argument("--profile-in", default=None,
                    help="load an observation store (JSON) from an earlier run")
    ap.add_argument("--profile-out", default=None,
                    help="save the observation store, this run's step time folded in")
    ap.add_argument("--autotune-cache", default=None,
                    help="JSON autotune cache (kernels/autotune.py): sweep the fused kernel's "
                         "K split at this pack's projection shapes, persist the result here, "
                         "run the tuned split and calibrate the cost-model prior with the "
                         "measured fused rate")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the run (autotuner and executor "
                         "spans); load it at ui.perfetto.dev or chrome://tracing")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry (counters, gauges, histograms) as JSON")
    for flag, kind in NOT_PORTED.items():
        if kind == "flag":
            ap.add_argument(flag, action="store_true", help="not ported yet")
        else:
            ap.add_argument(flag, default=None, help="not ported yet")
    args = ap.parse_args(argv)
    given = [f for f in NOT_PORTED if getattr(args, f[2:].replace("-", "_")) not in (None, False)]
    if given:
        ap.error(f"{', '.join(given)}: not ported yet (they wait for the port's multi-host "
                 "and sharded slices)")
    if (args.save_state or args.resume_state) and not args.pool:
        ap.error("--save-state/--resume-state require --pool")
    if args.autotune_cache:
        # the calibration prices FUSED-kernel rates, so the run must execute
        # the fused tier -- otherwise the planner would predict work the
        # kernels never do
        if args.impl in (None, "auto"):
            args.impl = "fused"
            print("autotune: --impl not set; running the fused tier the calibration measures")
        elif args.impl in ("pallas", "plain"):
            ap.error("--autotune-cache calibrates measured FUSED rates; combine it with "
                     "--impl fused/fused_pallas/fused_plain")
    return args


def _make_tracer(args):
    """One Tracer for the whole launch when --trace-out/--metrics-out asked
    for it, else the shared no-op; the autotuner and the executor receive
    this object."""
    if args.trace_out or args.metrics_out:
        return Tracer()
    return NULL_TRACER


def _export_obs(args, tracer) -> None:
    if args.trace_out:
        tracer.export(args.trace_out)
        print(f"saved Chrome trace to {args.trace_out} ({len(tracer.spans())} span(s)); "
              "open it in ui.perfetto.dev")
    if args.metrics_out:
        tracer.export_metrics(args.metrics_out)
        print(f"saved metrics to {args.metrics_out}")


def main(argv=None, *, executor=None, step_callback=None):
    """Run the launcher on ``argv`` (default: the command line); returns the
    per-adapter final losses. A caller that observes the run passes its own
    ``executor`` (a ``SliceExecutor``: its ``captures`` then stay readable;
    with --trace-out/--metrics-out it records into the launch's tracer)
    and ``step_callback(i, metrics)``, called after every step."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    ranks = [int(r) for r in args.ranks.split(",")]
    lrs = _floats(args.lrs)
    alphas = _floats(args.alphas) if args.alphas else [2.0 * r for r in ranks]
    bss = [int(b) for b in args.batch_sizes.split(",")] if args.batch_sizes else [1] * len(ranks)
    if not len(lrs) == len(ranks) == len(alphas) == len(bss):
        raise SystemExit("--ranks, --lrs, --alphas and --batch-sizes need one entry per adapter")
    configs = [
        LoraConfig(rank=r, alpha=a, learning_rate=lr, batch_size=b, seq_len=args.seq)
        for r, a, lr, b in zip(ranks, alphas, lrs, bss)
    ]
    meta = pack_meta(configs)
    print(f"arch={cfg.name} pack N={meta.n} r_bucket={meta.r_bucket} "
          f"steps={args.steps} seq={args.seq} device={dev}")

    device_pool = DevicePool([dev])
    slice_ = device_pool.acquire(1)
    quant = None if args.quant == "none" else args.quant
    # a quantized base is built layer by layer: the dense tree never exists
    base, lora = init_model(0, cfg, meta, device=dev, quant=quant)
    if quant:
        print(f"quantized frozen base to {quant} (projection weights -> codes+scales dicts, "
              "layer by layer)")

    opt, start_steps = None, None
    state_id = args.state_id or cfg.name
    if args.resume_state:
        lora, opt, smeta = CheckpointPool(args.pool).load_packed_state(state_id)
        if tuple(smeta["ranks"]) != meta.ranks:
            raise SystemExit(f"saved state {state_id!r} has ranks {smeta['ranks']}, "
                             f"requested {list(meta.ranks)}")
        start_steps = np.asarray(opt["step"]).tolist()
        print(f"resumed packed state {state_id!r} (per-adapter steps {start_steps})")

    def log(i, m):
        if args.log_every and i % args.log_every == 0:
            per = m["per_adapter_loss"].cpu().numpy()
            print(f"step {i:4d}  loss={float(m['loss']):.4f}  per-adapter={np.round(per, 3)}")
        if step_callback is not None:
            step_callback(i, m)

    store = ObservationStore.load(args.profile_in) if args.profile_in else ObservationStore()
    # priced at the tree's own storage and its dense leaves' dtype; the
    # kernel policy below stays ``quant``
    storage, dense = base_storage(base, dense=True)
    est = ProfiledCostModel(
        CostModel(cfg, PRESETS[args.hw], base_dtype=storage, dense_dtype=dense), store)
    tracer = _make_tracer(args)
    blocks, pred_uncalibrated = None, None
    if args.autotune_cache:
        from repro_torch.kernels.autotune import model_shapes, tune_for_model

        pred_uncalibrated = est.prior.iter_time(configs, 1, args.seq)
        prof = tune_for_model(cfg, configs, seq=args.seq, cache_path=args.autotune_cache,
                              fast=True, tracer=tracer, device=dev)
        est = ProfiledCostModel(prof.calibrate(est.prior), store)
        # the tuned K split of this pack's representative projection (None:
        # the plan's own choice won, or the CPU, whose plain path has none)
        blocks = prof.best_blocks(*model_shapes(cfg, configs, args.seq)[0])
        print(f"autotune: {len(prof.entries)} shape bucket(s) in {args.autotune_cache} "
              f"(backend={prof.backend}); prior calibrated with the measured fused rate "
              f"(x{prof.lora_speedup():.3f} on the LoRA term)"
              + (f", blocks={list(blocks)}" if blocks else ""))
    pred_prior = est.prior.iter_time(configs, 1, args.seq)
    pred_profiled = est.iter_time(configs, 1, args.seq)  # before observing

    ex = executor if executor is not None else SliceExecutor(tracer=tracer)
    if tracer.enabled:
        ex.tracer = tracer
    try:
        res = ex.train_pack(
            cfg, configs, n_steps=args.steps, seq=args.seq, base=base, lora=lora, opt=opt,
            slice_=slice_, data_start_steps=start_steps,
            step_callback=log if args.log_every or step_callback is not None else None,
            impl=args.impl, remat=args.remat, base_dtype=quant, blocks=blocks,
        )
    finally:
        device_pool.release(slice_)
    lora, opt = res.lora, res.opt
    tokens = sum(bss) * args.seq
    mode = "captured" if dev.type == "cuda" else "eager"
    print(f"done: {args.steps} steps in {res.wall_seconds:.2f} s "
          f"({args.steps * tokens / max(res.wall_seconds, 1e-9):.0f} tokens/s on {dev}, {mode})")

    # plan-vs-measured: how far the analytic prior (and a loaded profile)
    # was from this run
    if args.steps > 0:
        measured = res.wall_seconds / args.steps
        est.observe(configs, 1, args.seq, measured)

        def row(label, pred):
            drift = measured / pred - 1.0 if pred > 0 else float("nan")
            print(f"  {label:<22} {1e3 * pred:9.2f} ms/step   drift {100.0 * drift:+8.1f}%")

        print(f"\nplan-vs-measured  key={est.key(configs, 1, args.seq)}")
        print(f"  {'measured':<22} {1e3 * measured:9.2f} ms/step")
        if pred_uncalibrated is not None:
            row(f"prior ({est.hw.name})", pred_uncalibrated)
            row("prior, autotuned", pred_prior)
        else:
            row(f"prior ({est.hw.name})", pred_prior)
        if args.profile_in:
            row("profiled (loaded)", pred_profiled)
        print(f"  store: {len(store)} key(s), {store.n_observations} observation(s)")
    if args.profile_out:
        store.save(args.profile_out)
        print(f"saved profile to {args.profile_out}")

    per = res.losses if res.losses is not None else np.full(meta.n, np.nan)
    if args.pool:
        pool = CheckpointPool(args.pool)
        if args.save_state:
            pool.save_packed_state(
                state_id, lora, opt,
                {"arch": cfg.name, "ranks": list(meta.ranks), "alphas": list(meta.alphas),
                 "seq": args.seq, "steps_done": opt["step"].cpu().tolist()},
            )
            print(f"saved packed state {state_id!r} to {args.pool}")
        for i, c in enumerate(configs):
            pool.save_adapter(
                f"{cfg.name}_adapter_{i:03d}", extract_adapter(lora, i, meta.ranks),
                {"rank": c.rank, "alpha": c.alpha, "learning_rate": c.learning_rate,
                 "batch_size": c.batch_size, "final_loss": float(per[i])},
            )
        print(f"saved {len(configs)} adapters to {args.pool}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _export_obs(args, tracer)
    return per


if __name__ == "__main__":
    main()
