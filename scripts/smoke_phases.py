#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone on one CUDA card.

    python3 scripts/smoke_phases.py              # kernels, command_r, moe, jamba, serve, families
    python3 scripts/smoke_phases.py kernels      # the kernel phase alone
    python3 scripts/smoke_phases.py command_r    # the command_r phase alone
    python3 scripts/smoke_phases.py kernels moe  # the kernel rows and qwen3-moe-30b-a3b
    python3 scripts/smoke_phases.py kernels jamba  # the kernel rows and jamba-v0.1-52b
    python3 scripts/smoke_phases.py kernels serve  # the kernel rows, qwen25-7b's serve and
                                                   # its captured decode at 28 layers
    python3 scripts/smoke_phases.py kernels sweep  # the kernel rows, the sweep and tune_serve
    python3 scripts/smoke_phases.py kernels families
    python3 scripts/smoke_phases.py families:whisper-tiny,internvl2-1b  # some families

Builds the kernels, then runs ``chip_smoke.kernel_phase``,
``chip_smoke.command_r_phase``, ``chip_smoke.moe_phase``,
``chip_smoke.jamba_phase``, ``chip_smoke.serve_phase`` (one-shot and
chunked drains) with ``chip_smoke.serve_captured`` (eager against
captured decode on all 28 layers), ``chip_smoke.sweep_phase`` (the sweep through the serve
engine, then ``tune_serve`` on its pool; on the serve phase's base, or on
one of its own) and/or ``chip_smoke.families_phase`` (in the
smoke's order; ``families:<arch>,...`` runs those families alone) with the smoke's own checks (a failed check exits
non-zero), printing the smoke's JSON lines. With the kernel phase and
another, one ``phase_use`` line per ``kernels`` entry of that phase's
models: its layer sums, bound and launches, as the smoke's ``kernels`` line
would carry them. Every record also goes to
``smoke_out/smoke_phases.json``.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("kernels", "command_r", "moe", "jamba", "serve", "sweep", "families")


def main() -> None:
    which = sys.argv[1:] or list(PHASES)
    archs = None
    for i, p in enumerate(which):
        if p.startswith("families:"):
            which[i], archs = "families", p.split(":", 1)[1].split(",")
    if any(p not in PHASES for p in which):
        sys.exit(f"phases must be among {PHASES}, got {which}")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    _build.build_all()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    out = ROOT / "smoke_out"
    out.mkdir(exist_ok=True)
    rows, counts = [], {}
    if "kernels" in which:
        t0 = time.perf_counter()
        rows = cs.kernel_phase(torch, dev)
        cs.emit({"phase": "kernels_done", "seconds": time.perf_counter() - t0})
    if "command_r" in which:
        t0 = time.perf_counter()
        counts[cs.COMMAND_R] = cs.command_r_phase(torch, dev, out)
        cs.emit({"phase": "command_r_done", "seconds": time.perf_counter() - t0})
    if "moe" in which:
        t0 = time.perf_counter()
        counts[cs.MOE] = cs.moe_phase(torch, dev, out)
        cs.emit({"phase": "moe_phase_done", "seconds": time.perf_counter() - t0})
    if "jamba" in which:
        t0 = time.perf_counter()
        counts[cs.JAMBA] = cs.jamba_phase(torch, dev, out)
        cs.emit({"phase": "jamba_phase_done", "seconds": time.perf_counter() - t0})
    base = None
    if "serve" in which:
        t0 = time.perf_counter()
        counts["serve"], base = cs.serve_phase(torch, dev)
        cs.emit({"phase": "serve_done", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        counts["serve_captured"] = cs.serve_captured(torch, dev, base, out)
        cs.emit({"phase": "serve_captured_done", "seconds": time.perf_counter() - t0})
    if "sweep" in which:
        if base is None:
            from repro_torch.configs import get_config
            from repro_torch.models.model import init_model

            base, _ = init_model(cs.SEED, get_config("qwen25-7b"), None, dtype=torch.bfloat16,
                                 device=dev)
        t0 = time.perf_counter()
        sweep, counts["tune_serve"] = cs.sweep_phase(torch, dev, base, out)
        counts["sweep"] = {"auto": sweep}
        cs.emit({"phase": "sweep_done", "seconds": time.perf_counter() - t0})
    del base
    torch.cuda.empty_cache()
    if "families" in which:
        t0 = time.perf_counter()
        if archs is not None and any(a not in cs.FAMILIES for a in archs):
            sys.exit(f"families must be among {cs.FAMILIES}, got {archs}")
        counts.update(cs.families_phase(torch, dev, out, archs or cs.FAMILIES))
        cs.emit({"phase": "families_done", "seconds": time.perf_counter() - t0})
    if rows:
        for entry, kernel, calls, case, _src, _rep, (path, run, count), *dtype in cs.USES:
            if path not in counts:
                continue
            dtype = dtype[0] if dtype else "bfloat16"
            sel, tot = cs.layer_sums(rows, kernel, calls, case, dtype)
            cs.emit({"phase": "phase_use", "use": entry, "launches": counts[path][run][count],
                     "bound_ms": cs.bound(tot["bytes"], tot["flops"], dtype)[0],
                     "paths": sorted({r.get("path", "") for r in sel}), **tot})
    (out / "smoke_phases.json").write_text(json.dumps(cs.RECORDS, indent=1))


if __name__ == "__main__":
    main()
