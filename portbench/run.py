"""One run of one cell of ``BENCHMARK.json`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m portbench ...            (the same)

From the root of a checkout, in a new process:

  1. the cell, its configuration, its traffic and its limits by name (``spec``);
     a cell on several cards runs rank 0 in this process and the others in
     processes it starts and waits for (``run_ranks``), over NCCL;
  2. the training set and the start values from ``--seed``, on the card
     (``generate``, ``weights``; on several cards each rank makes its rows);
  3. ``rectpu_torch``'s Trainer, built as the family's trainer CLI builds it
     (``program``);
  4. set-up ends with three steps through the window's own call and feed,
     whose losses, first gradients and change the check reads, and one more
     call of three steps; ``setup_s`` runs from the process's start to here,
     less the time the check's readings took;
  5. the window: whole loops of ``steps_per_loop`` steps through
     ``Trainer.loop_runner``'s function, each loop's losses read back as the
     Trainer reads them, until ``--seconds`` have passed;
  6. with ``--trace 1``, two traced stretches after the window: two loops
     without Python stacks (idle share, the loop's host operations and step
     intervals, the breakdown) and ten steps with them (which module launched
     each kernel: the rooflines);
  7. the program's state is freed and the plain reference runs the same
     three steps (``refstep``); ``check`` compares them;
  8. the last line of standard output is the result, and the numbers
     compared, each with its limit, are the last lines of standard error.
     On several cards the rates and examples are every card's, the peak
     memory the fullest card's, busy and window time the cards' mean.

A run that finds no card, fewer cards than the cell asks for, or JAX or
rectpu loaded once the window has closed, in rank 0's process or in any
other rank's, exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "rectpu"))
CHECKED_STEPS = 3
WARM_STEPS = 3
TRACE_LOOPS = 2  # loops traced without stacks
STACK_STEPS = 10  # steps traced with Python stacks


def process_start() -> float:
    """The wall-clock time this process started, from /proc (10 ms ticks)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


@dataclass
class Context:
    """What a per-layer metric's ``read(ctx)`` reads."""

    conf: dict
    ref: object
    batch: int  # rows a card trains a step
    fields: int
    lookup_width: int
    optimizer: str
    leaves: dict  # {leaf: (rows, elements)} as the math has them
    distinct: float  # distinct table rows a step, over the stacked stretch's steps
    rate: float  # the window's examples a second, over every card
    chips: int
    a: object  # tracing.Segment without stacks
    b: object  # tracing.Segment with stacks


def _sync(cuda: bool) -> None:
    if cuda:
        import torch

        torch.cuda.synchronize()


def _distinct(data: dict, seed: int, n_rows: int, batch: int, steps) -> float:
    import torch

    from portbench import generate

    total = 0
    for s in steps:
        idx = torch.as_tensor(generate.batch_rows(seed, n_rows, batch, s),
                              device=data["cat_ids"].device)
        total += torch.unique(data["cat_ids"][idx]).numel()
    return total / len(steps)


def start(conf: dict, traffic: dict, ref, seed: int, device: str, job_dir: str, patch=None):
    """The training set, the program, and its first ``CHECKED_STEPS`` steps
    through the window's own call and feed, read for the check: returns
    (program, data, readings, seconds the readings took)."""
    from portbench import generate, program

    t0 = time.time()
    data = generate.make_dataset(traffic, conf["sparse_rows"], conf["dense_features"], seed,
                                 device)
    t1 = time.time()
    prog = program.build(conf, traffic, ref, data, seed, device, job_dir)
    print(f"portbench: set-up: data {t1 - t0:.3f} s, program and weights "
          f"{time.time() - t1:.3f} s", file=sys.stderr)
    if patch is not None:
        patch(prog)
    losses, readings_s = [], 0.0
    for s in range(CHECKED_STEPS):
        losses.append(float(loop_losses(prog, s, 1)[0]))
        if s == 0:
            t0 = time.time()
            grads = program.first_grad_norms(prog)
            readings_s += time.time() - t0
    t0 = time.time()
    changes = program.change_norms(prog, seed)
    readings = {"losses": losses, "grad_norms": grads, "changes": changes}
    if prog.plan is not None:  # every rank's shards, in rank 0's readings
        import torch.distributed as dist

        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, readings)
        for r in every:
            for key in ("grad_norms", "changes"):
                readings[key] = {**r[key], **readings[key]}
    readings_s += time.time() - t0
    return prog, data, readings, readings_s


def loop_losses(prog, step: int, k: int) -> list:
    """Steps ``step`` ... ``step + k - 1`` through the loop runner, and
    their losses read back as the Trainer reads them (under a plan the
    ranks' shares summed)."""
    out, _ = prog.run(prog.batches, step, k)
    if prog.plan is not None:
        out = prog.plan.global_value(out)
    return out.cpu().tolist()


def checked_batches(data: dict, seed: int, n_rows: int, batch: int) -> list:
    """The checked steps' batches, as the loader gave them to the program."""
    import torch

    from portbench import generate

    out = []
    for s in range(CHECKED_STEPS):
        idx = torch.as_tensor(generate.batch_rows(seed, n_rows, batch, s),
                              device=data["cat_ids"].device)
        out.append((data["cat_ids"][idx], data["num_vals"][idx], data["labels"][idx]))
    return out


def _agree(prog, flag: bool) -> bool:
    """Rank 0's decision on every rank (the window's end)."""
    return flag if prog.plan is None else prog.plan.agree(flag)


def rank0(prog) -> bool:
    """Whether this process is rank 0 (or the only one)."""
    return prog.plan is None or prog.plan.process_index == 0


def _over_ranks(prog, value: float, mean: bool = False) -> float:
    """The largest of every rank's ``value`` (``mean``: their mean)."""
    if prog.plan is None:
        return value
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64, device=prog.trainer.device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM if mean else dist.ReduceOp.MAX)
    return float(t) / (dist.get_world_size() if mean else 1)


def shard_ranges(prog) -> dict | None:
    """{table leaf: [(first row, end row) of each rank]} under a plan that
    shards the table, else None."""
    if not prog.shard:
        return None
    n = prog.plan.mesh.num_model
    return {k: [(i * (hi - lo), (i + 1) * (hi - lo)) for i in range(n)]
            for k, (lo, hi) in prog.shard.items()}


def free(cuda: bool) -> None:
    """Return the freed program's memory to the card before the reference."""
    gc.collect()
    if cuda:
        import torch

        torch.cuda.empty_cache()


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None, root: Path = ROOT,
             conf: dict | None = None, traffic: dict | None = None,
             limits: dict | None = None, patch=None) -> dict:
    """One run of ``cell``; returns the result (without printing it).
    ``conf``, ``traffic`` and ``limits`` default to the cell's files;
    ``patch(program)`` may change the built program (the tests plant faults
    with it)."""
    import torch

    from portbench import check, program, refstep, spec, tracing

    t_start = process_start() if t_start is None else t_start
    conf = conf or spec.config(bench, cell["config"], root)
    traffic = traffic or spec.traffic(cell["traffic"], root)
    limits = limits or spec.limits(cell["config"], root)
    ref = spec.reference(conf["family"], root)
    cuda = device == "cuda"
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        prog, data, readings, readings_s = start(conf, traffic, ref, seed, device,
                                                 str(tmp / "job"), patch)
        batch, n_rows = prog.args.batch_size, int(traffic["rows"])
        step = CHECKED_STEPS
        loop_losses(prog, step, WARM_STEPS)
        step += WARM_STEPS
        _sync(cuda)
        setup_s = _over_ranks(prog, time.time() - t_start - readings_s)
        if rank0(prog):
            print(f"portbench: set-up {setup_s:.3f} s, of it before the harness ran "
                  f"{T_IMPORT - t_start:.3f} s", file=sys.stderr)

        spl = prog.args.steps_per_loop
        steps, failed = 0, 0
        t0 = time.perf_counter()
        while True:
            failed += sum(not math.isfinite(v) for v in loop_losses(prog, step, spl))
            step += spl
            steps += spl
            if _agree(prog, time.perf_counter() - t0 >= seconds):
                break
        _sync(cuda)
        window_s = time.perf_counter() - t0
        rate = steps * batch / window_s
        peak = int(_over_ranks(prog, torch.cuda.max_memory_allocated() if cuda else 0))

        seg_a = seg_b = None
        distinct = 0.0
        if trace:
            def loops(first, n, k):
                for i in range(n):
                    loop_losses(prog, first + i * k, k)

            seg_a = tracing.capture(lambda: loops(step, TRACE_LOOPS, spl), TRACE_LOOPS * spl,
                                    stack=False, tmpdir=tmp, cuda=cuda)
            step += TRACE_LOOPS * spl
            k = min(STACK_STEPS, spl)
            seg_b = tracing.capture(lambda: loops(step, 1, k), k, stack=True, tmpdir=tmp,
                                    cuda=cuda)
            distinct = _distinct(data, seed, n_rows, batch, range(step, step + k))
            step += k

        specs, opt = prog.specs, program.optimizer_spec(prog)
        shards = shard_ranges(prog)
        first = rank0(prog)
        layer = {}
        if trace:
            vocab = sum(int(r) for r in conf["sparse_rows"])
            leaves = {}
            for key, (shape, _) in specs.items():
                rows = vocab if key in ref.TABLE_LEAVES else (shape[0] if shape else 1)
                leaves[key] = (rows, rows * math.prod(shape[1:]) if shape else 1)
            chips = int(cell["chips"])
            ctx = Context(conf, ref, batch // chips, len(conf["sparse_rows"]),
                          ref.lookup_width(conf), opt["name"], leaves, distinct, rate, chips,
                          seg_a, seg_b)
            for m in spec.cell_metrics(bench, cell["name"], "per_layer"):
                mod = spec.metric(m["name"], root)
                if getattr(mod, "SLOWEST_RANK", False):  # every rank reads; the largest
                    value = mod.read(ctx)
                    value = _over_ranks(prog, -math.inf if value is None else value)
                    value = None if value == -math.inf else value
                else:
                    value = mod.read(ctx) if first else None
                if value is not None:
                    layer[m["name"]] = {"value": value, "unit": m["unit"]}
            busy = {"busy_s": _over_ranks(prog, seg_a.busy_s, mean=True),
                    "window_s": _over_ranks(prog, seg_a.window_s, mean=True)}
        checked = checked_batches(data, seed, n_rows, batch) if first else None
        del prog, data
        free(cuda)
        if not first:
            return None
        numbers = check.compare(readings, refstep.reference_run(
            ref, conf, specs, seed, checked, opt, shards=shards))
        correct = check.judge(numbers, limits) and failed == 0

        e2e = {"train_examples_per_s": rate, "peak_mem_gib": peak / 2 ** 30,
               "setup_s": setup_s}
        result = {"correct": correct, "attempted": steps, "failed": failed, "metrics": layer}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": int(cell["chips"]), "memory_peak_bytes": peak}
        if not trace:
            for m in spec.cell_metrics(bench, cell["name"], "end_to_end"):
                result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        else:
            dev.update(busy)
            result["breakdown"] = {"device_ops": seg_a.top_ops(), "idle_gaps": seg_a.idle_gaps()}
        result["device"] = dev
        result["check"] = {n: {"value": numbers[n], "limit": limits[n]} for n in check.NUMBERS}
        result["check"]["window_nonfinite_losses"] = {"value": failed, "limit": 0}
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rank_run(rank: int, world: int, port: int, run: tuple):
    """Rank ``rank`` of a cell on ``world`` cards: the process group by the
    program's own ``distributed_init`` (NCCL across the cards, Gloo on the
    CPU), then ``run_cell``; returns rank 0's result, None elsewhere.
    ``run``: (workload, seed, seconds, trace, device, start time[, run_cell's
    keyword arguments])."""
    import torch.distributed as dist
    from rectpu_torch.parallel.mesh import distributed_init

    from portbench import spec

    workload, seed, seconds, trace, device, t_start, *given = run
    distributed_init(device, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                     rank=rank)
    try:
        bench = spec.benchmark()
        result = run_cell(bench, spec.cell(bench, workload), seed, seconds, trace,
                          device=device, t_start=t_start, **(given[0] if given else {}))
    finally:
        dist.destroy_process_group()
    bad = forbidden_modules()
    if bad and rank:  # rank 0 runs in the process that prints, which checks itself
        print(f"portbench: rank {rank} loaded {', '.join(bad)}, which the port must not use",
              file=sys.stderr)
        sys.exit(3)
    return result


def run_ranks(world: int, run: tuple, target=rank_run):
    """``target(rank, world, port, run)`` for ranks 1 ... world - 1 in
    processes of their own and for rank 0 in this one, which waits until
    every other has ended: (rank 0's result, the ranks that failed)."""
    import multiprocessing
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    kids = [ctx.Process(target=target, args=(r, world, port, run)) for r in range(1, world)]
    for k in kids:
        k.start()
    result = None
    try:
        result = target(0, world, port, run)
    finally:
        for k in kids:
            k.join(timeout=120)
            if k.is_alive():
                k.terminate()
                k.join()
    return result, [r for r, k in enumerate(kids, start=1) if k.exitcode != 0]


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative integer")

    from portbench import counts, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: {counts.power_limit()}; peaks: fp32 {counts.PEAK_FLOPS['float32']:.4g} "
          f"FLOP/s (3xTF32), bf16 {counts.PEAK_FLOPS['bfloat16']:.4g} FLOP/s, "
          f"{counts.PEAK_BYTES:.4g} B/s", file=sys.stderr)
    run = (args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    if int(cell["chips"]) == 1:
        result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
        return report(result, [])
    return report(*run_ranks(int(cell["chips"]), run))


def report(result: dict, failed: list) -> int:
    """Print the result (the numbers compared last on standard error, the
    result's line last on standard output) and return 0; or print no result
    and return non-zero when a rank failed, another rank's process among
    them (each checks its own modules), or this process loaded JAX or the
    JAX package."""
    if failed:
        print(f"portbench: ranks {failed} failed; no result", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}, which the port must not use; "
              "no result", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
