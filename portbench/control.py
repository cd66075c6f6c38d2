"""The readings that ``correct``'s limits are set from, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11 12 ... [--out file]

For each seed, in one process: the program's set-up and first three steps as
a run makes them (``run.start``), then the program's state freed, then the
plain reference three times on the same batches and start values: in
float32 (the program is compared with it: the lower reading), in TF32 (the
control: the reference in the precision below the configuration's float32),
and with half of each batch left out of the mean (a planted fault). A step
that leaves its state unchanged reads ``update_gap`` = 1 by the measure
itself and needs no run. Prints one JSON line a seed. The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def no_exchange(prog) -> None:
    """A planted fault: the step's sum of the gradients over the ranks
    (``ParallelPlan.reduce_grads``) left out."""
    prog.plan.reduce_grads = lambda grads, table_grad_dtype=None: grads


FAULTS = {"no_exchange": no_exchange}


def readings(bench: dict, cell: dict, seed: int, device: str = "cuda", root: Path = ROOT,
             conf: dict | None = None, traffic: dict | None = None,
             fault: str | None = None) -> dict | None:
    """One seed's readings (on rank 0; None on the other ranks of a run
    over several cards). ``fault`` plants one of ``FAULTS`` in the program."""
    from portbench import check, program, refstep, run, spec

    conf = conf or spec.config(bench, cell["config"], root)
    traffic = traffic or spec.traffic(cell["traffic"], root)
    ref = spec.reference(conf["family"], root)
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
        prog, data, got, _ = run.start(conf, traffic, ref, seed, device, str(Path(tmp) / "job"),
                                       FAULTS[fault] if fault else None)
        specs, opt = prog.specs, program.optimizer_spec(prog)
        shards, first = run.shard_ranges(prog), run.rank0(prog)
        batches = run.checked_batches(data, seed, int(traffic["rows"]), prog.args.batch_size)
        del prog, data
        run.free(device == "cuda")
    if not first:
        return None
    fp32 = refstep.reference_run(ref, conf, specs, seed, batches, opt, shards=shards)
    out = {"seed": seed, "program": check.compare(got, fp32),
           "program_worst": check.worst_leaves(got, fp32), "program_losses": got["losses"]}
    if fault:
        return dict(out, fault=fault)
    tf32 = refstep.reference_run(ref, conf, specs, seed, batches, opt, precision="tf32",
                                 shards=shards)
    half = refstep.reference_run(ref, conf, specs, seed, batches, opt, half_batch=True,
                                 shards=shards)
    return dict(out, control_tf32=check.compare(tf32, fp32),
                fault_half_batch=check.compare(half, fp32))


def rank_readings(rank: int, world: int, port: int, job: tuple) -> list | None:
    """Every seed's readings on rank ``rank`` of a run over ``world`` cards."""
    import torch.distributed as dist
    from rectpu_torch.parallel.mesh import distributed_init

    from portbench import spec

    workload, seeds, device, fault, given = job
    distributed_init(device, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                     rank=rank)
    try:
        bench = spec.benchmark()
        cell = spec.cell(bench, workload)
        return [readings(bench, cell, s, device, fault=fault, **given) for s in seeds]
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from portbench import run, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    chips = int(cell["chips"])
    t0 = time.time()
    if chips == 1:
        rows = [readings(bench, cell, s, fault=args.fault) for s in args.seeds]
    else:
        rows, failed = run.run_ranks(chips, (args.workload, args.seeds, "cuda", args.fault, {}),
                                     target=rank_readings)
        if failed:
            print(f"portbench.control: ranks {failed} failed", file=sys.stderr)
            return 4
    lines = [json.dumps(dict(r, cell=args.workload, seconds=(time.time() - t0) / len(rows)))
             for r in rows]
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
