#!/usr/bin/env python3
"""Time another tree's kernels with this tree's chip_smoke.py phases, on one GPU.

    python3 chip_compare.py <tree root> [--phases time,step] [--seed 0] [--out f.json]

Runs phase functions of the chip_smoke.py beside this script against the
rectpu_torch package of <tree root> (this checkout, or a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists), so a
kernel and its predecessor are timed by one method in one call:

- ``check``: chip_smoke.check_zoo_kernels (the interaction and CIN kernels
  against their plain versions);
- ``time``: every kernel time of chip_smoke.py's phase 7 (time_kernels,
  time_train_kernels, time_zoo_kernels, time_fast_kernels,
  time_flat_kernels), one line a row;
- ``step``: bench.py's DeepFM flagship step (chip_smoke.flagship_step), the
  sparse fast step at full width (chip_smoke.fast_step_full_width) and the
  xDeepFM zoo step in fp32 and in bf16 (chip_smoke.zoo_step): median wall,
  the device's busy time, the device time of the lookup, FM-forward,
  FM-backward and CIN kernels and of elementwise copies and casts, launches
  per step.

A tree whose ops/cin.py counts fp32 launches with bf16's (before the fp32
counters) has its counter read under both names; a tree whose lookup kernel
does not round fp32 rows to bf16 is timed on the flagship gather by its own
route (the table cast, then the kernel). It builds the tree's sources up
front (one nvcc each, all started together) and prints their ptxas report.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="the tree whose rectpu_torch is timed")
    ap.add_argument("--phases", default="time,step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import rectpu_torch
    import torch

    if not Path(rectpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"rectpu_torch came from {rectpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        print("chip_compare: no GPU", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name, older in (("launches_fp32", "launches"), ("dw_launches_fp32", "dw_launches")):
        if not hasattr(cs.cin_ops, name):
            setattr(cs.cin_ops, name, getattr(cs.cin_ops, older))

    t0 = time.perf_counter()
    dev = cs.resolve_device("cuda")
    gpu = cs.gpu_line()
    print(f"tree {root} [{gpu}]", flush=True)
    for r in cs.build.build():
        for kernel, regs, spill in cs.ptxas_report(r.log):
            print(f"ptxas {r.name}: {kernel}: {regs} registers, {spill} bytes spilled")
    gen = torch.Generator().manual_seed(args.seed)
    out = {"tree": str(root), "gpu": gpu}
    phases = args.phases.split(",")
    if "check" in phases:
        out["errs"] = cs.check_zoo_kernels(dev, gen)
    if "time" in phases:
        floor, rows = cs.time_kernels(dev, gen)
        rows += (cs.time_train_kernels(dev, gen) + cs.time_zoo_kernels(dev, gen)
                 + cs.time_fast_kernels(dev, gen) + cs.time_flat_kernels(dev, gen))
        out.update(floor_ms=floor, times=rows)
        for r in rows:
            tf32 = f", 3xTF32 bound {r['bound_3xtf32_ms']:.4f}" if "bound_3xtf32_ms" in r else ""
            if "cast_then_gather_ms" in r:
                tf32 += f", the table cast then the kernel {r['cast_then_gather_ms']:.4f}"
            plain, lib = ("n/a" if r.get(k) is None else f"{r[k]:.4f}"
                          for k in ("plain_ms", "library_ms"))
            print(f"time: {r['name']} {r['dtype']} {r.get('shape', '')} {r.get('call', '')} "
                  f"{r.get('batch', r.get('v_rows', ''))}: {r['ms']:.4f} ms, plain {plain}, "
                  f"library {lib}, bound {r['bound_ms']:.4f}{tf32} [{gpu}]", flush=True)
    if "step" in phases:
        work = Path(tempfile.mkdtemp(prefix="chip_compare_"))
        steps = [("flagship_step_deep_fm", lambda: cs.flagship_step(dev, gen, work)),
                 ("fast_step_deep_fm", lambda: cs.fast_step_full_width(dev, args.seed, work))]
        steps += [(f"zoo_step_xdeep_fm{'_fp32' if fp32 else ''}",
                   lambda fp32=fp32: cs.zoo_step("xdeep_fm", dev, gen, work, fp32=fp32))
                  for fp32 in (True, False)]
        for label, run in steps:
            res = out[label] = run()
            prof = res["profile"]
            print(f"{label}: median {res['step_ms']:.4f} ms, {res['examples_per_s']:.0f} "
                  f"examples/s, device busy {prof['device_busy_ms']} ms in "
                  f"{prof['device_launches']:.0f} device launches; device ms: lookup "
                  f"{prof['lookup_device_ms']:.4f}, FM forward {prof['fm_fwd_device_ms']:.4f}, "
                  f"FM backward {prof['fm_bwd_device_ms']:.4f}, "
                  f"CIN {prof['cin_device_ms']:.4f}, elementwise copies and casts "
                  f"{prof['copy_device_ms']:.4f}; top kernels "
                  f"{[(k, round(t, 4)) for k, t in prof['top_kernels_ms']]}; launches per step "
                  f"{res['launches_per_step']} [{gpu}]", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
