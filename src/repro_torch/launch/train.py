"""Training launcher: train one pack of LoRA configurations on one device
(the port of the single-device path of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen25-7b \\
      --reduced --steps 20 --ranks 8,16 --lrs 1e-3,5e-4 --seq 32

It runs on CUDA unless ``--device`` says otherwise (``--device cpu`` for a
run without a card; with no device given and no CUDA it raises). The step is
``make_packed_step``; the reference's cluster, planner, autotune, profile,
checkpoint-pool and tracing flags are not ported yet and raise if given.
The model is initialized from a seed in f32, as the reference's launcher
does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import LoraConfig, get_config, list_archs, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.kernels.ops import IMPLS, REMATS
from repro_torch.kernels.quant import quantize_base_params
from repro_torch.models.model import init_model
from repro_torch.train.data import packed_batch_iterator
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.trainer import make_packed_step

# the reference launcher's flags that wait for later slices of the port
NOT_PORTED = {
    "--mesh": "value", "--autotune-cache": "value", "--hosts": "value",
    "--devices-per-host": "value", "--host-classes": "value", "--heartbeat": "value",
    "--drain-after": "value", "--join-after": "value", "--fsdp": "flag",
    "--seq-parallel": "flag", "--pool": "value", "--profile-in": "value",
    "--profile-out": "value", "--hw": "value", "--save-state": "flag",
    "--resume-state": "flag", "--state-id": "value", "--trace-out": "value",
    "--metrics-out": "value",
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
    for flag, kind in NOT_PORTED.items():
        if kind == "flag":
            ap.add_argument(flag, action="store_true", help="not ported yet")
        else:
            ap.add_argument(flag, default=None, help="not ported yet")
    args = ap.parse_args(argv)
    given = [f for f in NOT_PORTED if getattr(args, f[2:].replace("-", "_")) not in (None, False)]
    if given:
        ap.error(f"{', '.join(given)}: not ported yet (the port trains one pack on one device)")
    return args


def main(argv=None):
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

    base, lora = init_model(0, cfg, meta, device=dev)
    quant = None if args.quant == "none" else args.quant
    if quant:
        base = quantize_base_params(base, quant)
        print(f"quantized frozen base to {quant} (projection weights -> codes+scales dicts)")
    step = make_packed_step(cfg, meta.n, impl=args.impl, remat=args.remat, ranks=meta.ranks,
                            base_dtype=quant)
    opt = init_opt_state(lora)
    it = packed_batch_iterator(cfg, configs, seq=args.seq, device=dev)
    scales, lr_vec = meta.scales(dev), meta.lr_vector(dev)
    tokens = sum(bss) * args.seq
    t0 = time.perf_counter()
    for i in range(args.steps):
        lora, opt, m = step(base, lora, opt, next(it), scales, lr_vec, None)
        if args.log_every and i % args.log_every == 0:
            per = m["per_adapter_loss"].cpu().numpy()
            print(f"step {i:4d}  loss={float(m['loss']):.4f}  per-adapter={np.round(per, 3)}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    per = m["per_adapter_loss"].cpu().numpy()
    print(f"done: {args.steps} steps in {wall:.2f} s ({args.steps * tokens / wall:.0f} tokens/s "
          f"on {dev}); final per-adapter loss {np.round(per, 4)}")
    return per


if __name__ == "__main__":
    main()
