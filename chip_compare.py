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
- ``step``: the xDeepFM zoo step in fp32 and in bf16 (chip_smoke.zoo_step:
  median wall, busy time, the CIN kernels' device time, launches per step).

A tree whose ops/cin.py counts fp32 launches with bf16's (before the fp32
counters) has its counter read under both names. It builds only the
tree's cin.cu up front (the others build at first use) and prints its ptxas
report.
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
    for r in cs.build.build(["cin"]):
        for kernel, regs, spill in cs.ptxas_report(r.log):
            print(f"ptxas cin: {kernel}: {regs} registers, {spill} bytes spilled")
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
            plain, lib = ("n/a" if r.get(k) is None else f"{r[k]:.4f}"
                          for k in ("plain_ms", "library_ms"))
            print(f"time: {r['name']} {r['dtype']} {r.get('shape', '')} {r.get('call', '')} "
                  f"{r.get('batch', r.get('v_rows', ''))}: {r['ms']:.4f} ms, plain {plain}, "
                  f"library {lib}, bound {r['bound_ms']:.4f}{tf32} [{gpu}]", flush=True)
    if "step" in phases:
        work = Path(tempfile.mkdtemp(prefix="chip_compare_"))
        for fp32 in (True, False):
            zoo = cs.zoo_step("xdeep_fm", dev, gen, work, fp32=fp32)
            prof = zoo["profile"]
            out[f"zoo_step_xdeep_fm{'_fp32' if fp32 else ''}"] = zoo
            print(f"zoo step xdeep_fm {'fp32' if fp32 else 'bf16'}: median "
                  f"{zoo['step_ms']:.4f} ms, {zoo['examples_per_s']:.0f} examples/s, device busy "
                  f"{prof['device_busy_ms']} ms, CIN kernels {prof['cin_device_ms']} ms, "
                  f"{prof['device_launches']:.0f} device launches, launches per step "
                  f"{zoo['launches_per_step']} [{gpu}]", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
