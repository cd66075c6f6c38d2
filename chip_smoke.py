#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rectpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Run from the root of a checkout; it needs one CUDA card, the CUDA toolkit
(nvcc) and nothing of JAX or of the rectpu package. Phases, in order; any
failed check raises, and the script exits nonzero without the final line:

1. Build: compile every CUDA kernel of the serving path from
   rectpu_torch/kernels/csrc (one nvcc per source, in parallel, sm_90a).
2. Kernels against their plain PyTorch versions, on the card: the lookup on
   the served [4224, 65] table at B in {1, 7, 512, 4096} x 26 fields
   (bitwise, out-of-range ids give zero rows) and the FM on the strided view
   looked[..., :K] at K in {64, 4} (and a contiguous 28-field input), in
   fp32 and bf16.
3. Main path: DeepFM at the flagship widths (K=64, hidden [256, 128]) from a
   seeded torch.Generator, in bf16 and in fp32, written by the port's
   export_model and served by the port's HTTP server (micro-batching on) on
   127.0.0.1. /predict bodies of 1, 8 and 64 instances plus a concurrent
   burst, /healthz and /metrics. Every response is checked against a
   device="cpu" ServingModel of the same export, and both kernels' launch
   counts must have grown during the requests. Then /predict latency on the
   host clock, the host/device split of one 512-instance request, and the
   device's busy time in one forward (torch.profiler).
4. Times: CUDA-event times of each kernel at B=512 and B=4096 (inputs cold
   in device memory, and L2-warm) beside its plain version, its bound and,
   for the lookup, torch.index_select.

The second-to-last lines are the kernels' JSON summary and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from rectpu_torch.device import resolve_device
from rectpu_torch.features.schema import GENRE, ml_100k_feature_set
from rectpu_torch.kernels import build
from rectpu_torch.models import DeepFMModel, TowerConfig
from rectpu_torch.ops import embedding as emb_ops
from rectpu_torch.ops import fm as fm_ops
from rectpu_torch.serve.export import export_model, load_model
from rectpu_torch.serve.server import instances_to_columns, make_server, parse_request_columns

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
V_ROWS, WIDTH, FIELDS, K = 4224, 65, 26, 64  # served ml-100k table, flagship K

# tolerances against the plain version / the CPU reference, with reasons
FM_RTOL_OF_SCALE = 1e-5  # fp32 sums in another order; relative to 0.5*sum_k(S^2+Q)
BF16_REL_ULP = 2.0 ** -7  # one bf16 ulp, relative to the value (8-bit significand)
FP32_LOGIT_ATOL = 1e-4  # fp32 card vs CPU: 1,664-long dot products in another order
BF16_LOGIT_ATOL, BF16_LOGIT_RTOL = 2e-2, 1e-2  # bf16 activations may round one ulp apart


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    check(bool(out), "nvidia-smi printed no name and power limit")
    return out.splitlines()[0]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def fm_tolerance(v: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|kernel - plain| allowed per row: fp32 rounding of sums taken in
    another order, relative to the magnitude of the summed terms, plus one
    bf16 ulp of the value when the output is bf16 (the two fp32 results may
    round to neighbouring bf16 values)."""
    v64 = v.double()
    scale = 0.5 * (v64.sum(1) ** 2 + (v64 * v64).sum(1)).sum(-1)
    tol = FM_RTOL_OF_SCALE * scale
    if want.dtype == torch.bfloat16:
        tol = tol + BF16_REL_ULP * want.double().abs()
    return tol


# --- phase 2: kernels against their plain versions --------------------------


def check_kernels(dev, gen) -> dict:
    errs = {"embedding_lookup": 0.0, "fm_cross": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        table = (torch.randn(V_ROWS, WIDTH, generator=gen) * 0.1).to(dtype).to(dev)
        for b in (1, 7, 512, 4096):
            ids = torch.randint(0, V_ROWS, (b, FIELDS), generator=gen, dtype=torch.int32)
            bad = torch.tensor([-1, V_ROWS, V_ROWS + 100, -2**31, 2**31 - 1], dtype=torch.int32)
            ids.view(-1)[:5] = bad
            ids = ids.to(dev)
            got = emb_ops.lookup_cuda(table, ids)
            want = emb_ops.lookup_take(table, ids)
            torch.cuda.synchronize()
            check(got.shape == (b, FIELDS, WIDTH), f"lookup shape {tuple(got.shape)}")
            check(same_bits(got, want), f"lookup {dtype} B={b}: kernel != plain bitwise")
            check(not got.reshape(-1, WIDTH)[:5].any(), "out-of-range ids gave nonzero rows")
        print(f"check: embedding_lookup {dtype} B=1,7,512,4096 bitwise equal to plain, "
              "out-of-range ids -> zero rows")
    for dtype in (torch.float32, torch.bfloat16):
        for k in (64, 4):
            for b in (1, 7, 512, 4096):
                fused = (torch.randn(b, FIELDS, k + 1, generator=gen) * 0.3).to(dtype).to(dev)
                inputs = [fused[..., :k]]  # the strided view the model hands over
                if k == K:  # with numeric fields the model concatenates: contiguous
                    inputs.append((torch.randn(b, FIELDS + 2, k, generator=gen) * 0.3)
                                  .to(dtype).to(dev))
                for v in inputs:
                    got = fm_ops.fm_cross_cuda(v)
                    want = fm_ops.fm_cross_xla(v)
                    torch.cuda.synchronize()
                    check(got.shape == (b,) and got.dtype == dtype, "fm shape/dtype")
                    err = (got.double() - want.double()).abs()
                    check(bool((err <= fm_tolerance(v, want)).all()),
                          f"fm {dtype} B={b} K={k} F={v.shape[1]}: max err {err.max().item()}")
                    errs["fm_cross"] = max(errs["fm_cross"], err.max().item())
        print(f"check: fm_cross {dtype} K=64,4 B=1,7,512,4096 within tolerance of plain "
              f"(max abs err so far {errs['fm_cross']:.3g})")
    return errs


# --- phase 3: the main path -------------------------------------------------


def make_export(job_dir: Path, compute_dtype, gen) -> Path:
    cfg = TowerConfig(feature_set=ml_100k_feature_set(), embedding_size=K,
                      hidden_units=(256, 128), compute_dtype=compute_dtype,
                      packed_linear=True, fm_impl="pallas" if compute_dtype else "auto")
    model = DeepFMModel(cfg)
    params = model.init(gen)
    # random linear weights and bias (the initializer's zeros would hide the
    # linear column of the fused gather)
    params["table"][:, K] = torch.randn(params["table"].shape[0], generator=gen) * 0.05
    params["linear"]["b"] = torch.tensor(0.1)
    return export_model(params, model, job_dir, step=1)


def make_instances(rng, n: int) -> list[dict]:
    occupations = ["student", "writer", "engineer", "none", "artist", "doctor", "other"]
    out = []
    for i in range(n):
        inst = {
            "user_id": int(rng.integers(1, 944)),
            "item_id": int(rng.integers(1, 1683)),
            "age": int(rng.integers(7, 74)),
            "gender": str(rng.choice(["F", "M", "X"])),
            "occupation": str(rng.choice(occupations)),
            "zipcode": f"{int(rng.integers(0, 100000)):05d}",  # string, leading zeros kept
            "release_year": int(rng.integers(1922, 1999)),
        }
        if i % 3:  # every third instance has no genre flags at all (they default to 0)
            for g in rng.choice(GENRE, size=int(rng.integers(1, 4)), replace=False):
                inst[str(g)] = 1
        out.append(inst)
    return out


def post(base: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        check(r.status == 200, f"{path} returned {r.status}")
        return json.loads(r.read())


def get(base: str, path: str) -> bytes:
    with urllib.request.urlopen(base + path, timeout=120) as r:
        check(r.status == 200, f"{path} returned {r.status}")
        return r.read()


def check_predictions(preds: list, instances: list, ref, label: str, atol, rtol) -> float:
    check(len(preds) == len(instances), f"{label}: {len(preds)} predictions for "
                                        f"{len(instances)} instances")
    logits = np.array([p["logits"] for p in preds], np.float64)
    probs = np.array([p["probabilities"] for p in preds], np.float64)
    check(bool(np.isfinite(logits).all() and np.isfinite(probs).all()), f"{label}: non-finite")
    check(bool(((probs >= 0) & (probs <= 1)).all()), f"{label}: probability outside [0, 1]")
    want = ref.predict(instances_to_columns(instances))
    err = np.abs(logits - want["logits"])
    check(bool((err <= atol + rtol * np.abs(want["logits"])).all()),
          f"{label}: logits differ from the CPU reference by up to {err.max():.3g}")
    return float(err.max())


def serve_and_check(export_dir: Path, label: str, seed: int, latency_sizes) -> dict:
    """Serve one export on the card, drive /predict, hold it against the CPU."""
    ref = load_model(export_dir, device="cpu")
    httpd, served = make_server(export_dir=str(export_dir), port=0, device="cuda",
                                batch_window_ms=2.0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(seed)
    atol, rtol = ((BF16_LOGIT_ATOL, BF16_LOGIT_RTOL) if "bf16" in label
                  else (FP32_LOGIT_ATOL, 0.0))
    out = {"max_logit_err": 0.0}
    try:
        emb_ops.launches.reset()
        fm_ops.launches.reset()
        bodies = [make_instances(rng, n) for n in (1, 8, 64)]
        replies = [post(base, "/predict", {"instances": b})["predictions"] for b in bodies]
        # a concurrent burst, which the micro-batcher coalesces
        burst = [make_instances(rng, 8) for _ in range(8)]
        burst_replies = [None] * len(burst)

        def one(i):
            burst_replies[i] = post(base, "/predict", {"instances": burst[i]})["predictions"]

        workers = [threading.Thread(target=one, args=(i,)) for i in range(len(burst))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        check(all(r is not None for r in burst_replies), f"{label}: burst request failed")
        check(get(base, "/healthz") == b"ok", "/healthz")
        metrics = json.loads(get(base, "/metrics"))
        out["launches"] = {"embedding_lookup": emb_ops.launches.value,
                           "fm_cross": fm_ops.launches.value}
        out["metrics"] = metrics
        for name, n in out["launches"].items():
            check(n > 0, f"{label}: kernel {name} was not launched on the main path")
        for b, r in zip(bodies + burst, replies + burst_replies):
            out["max_logit_err"] = max(out["max_logit_err"],
                                       check_predictions(r, b, ref, label, atol, rtol))
        check(metrics.get("requests_served") == len(bodies) + len(burst),
              f"{label}: /metrics {metrics}")
        out["latency_ms"] = {}
        for n in latency_sizes:
            body = {"instances": make_instances(rng, n)}
            post(base, "/predict", body)
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                post(base, "/predict", body)
                times.append((time.perf_counter() - t0) * 1e3)
            out["latency_ms"][n] = statistics.median(times)
        out["breakdown_ms"] = request_breakdown(served.served, make_instances(rng, 512))
        out["forward_profile"] = profile_forward(served.served, make_instances(rng, 512))
    finally:
        httpd.shutdown()
        httpd.server_close()
        served.close()
        thread.join(timeout=30)
    check(not thread.is_alive(), f"{label}: server thread did not stop")
    return out


def request_breakdown(model, instances: list, reps: int = 20) -> dict:
    """Median host-clock ms of each step of one /predict outside HTTP: JSON
    parse to columns, request encode (FarmHash, CPU), and the forward on the
    card including the host->device and device->host copies."""
    raw = json.dumps({"instances": instances}).encode()
    steps = {"parse": [], "encode": [], "forward": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        columns, n = parse_request_columns(raw)
        t1 = time.perf_counter()
        batch = model.encode_request(columns)
        t2 = time.perf_counter()
        model.apply_encoded(batch, n)  # ends in a device->host copy: synchronous
        t3 = time.perf_counter()
        for k, dt in zip(steps, (t1 - t0, t2 - t1, t3 - t2)):
            steps[k].append(dt * 1e3)
    return {"instances": len(instances), **{k: statistics.median(v) for k, v in steps.items()}}


def profile_forward(model, instances: list, reps: int = 20) -> dict:
    """Wall ms of one synchronous forward (host clock, profiler off) beside the
    device's busy ms in it (torch.profiler, CUPTI), and the kernels that take
    the most device time. Busy time is the sum of the device-side events'
    times (kernels and copies)."""
    from torch.profiler import ProfilerActivity, profile

    batch = model.encode_request(instances_to_columns(instances))
    n = len(instances)
    model.apply_encoded(batch, n)
    t0 = time.perf_counter()
    for _ in range(reps):
        model.apply_encoded(batch, n)
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            model.apply_encoded(batch, n)
    # device-side events only (kernels, copies): an operator's own entry
    # repeats the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / reps / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return {"instances": n, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if events else None,
            "top_kernels_ms": [(e.key[:60], e.self_device_time_total / reps / 1e3)
                               for e in top]}


# --- phase 4: times ---------------------------------------------------------


def time_ms(fn, flush: torch.Tensor | None, iters: int = 50) -> float:
    """Median CUDA-event time of one call on the device. With ``flush``, a
    read of a buffer larger than the 50 MB L2 precedes each launch, so the
    call finds its inputs in device memory (a read leaves clean lines: a
    flushing WRITE would leave 50 MB of dirty lines whose write-back lands
    inside the timed call). A sleep kernel queued first keeps the card busy
    while the host enqueues every launch, so no event pair spans host
    overhead (a wrapper's Python and ctypes cost is tens of microseconds,
    more than these kernels take)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles
    for start, end in pairs:
        if flush is not None:
            flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_kernels(dev, gen) -> tuple[float, list[dict]]:
    """(floor, rows): the floor is the same timing of a one-element add, the
    least any launch reads by this method; rows time each kernel."""
    flush = torch.ones(64 * 2**20 // 4, dtype=torch.float32, device=dev)  # > 50 MB L2
    one = torch.zeros(1, device=dev)
    floor = time_ms(lambda: one.add_(1.0), None)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.empty((), dtype=dtype).element_size()
        table = (torch.randn(V_ROWS, WIDTH, generator=gen) * 0.1).to(dtype).to(dev)
        for b in (512, 4096):
            ids = torch.randint(0, V_ROWS, (b, FIELDS), generator=gen,
                                dtype=torch.int32).to(dev)
            ids_long = ids.reshape(-1).long()
            n = b * FIELDS
            nbytes = n * 4 + V_ROWS * WIDTH * es + n * WIDTH * es
            rows.append({
                "name": "embedding_lookup", "dtype": str(dtype).split(".")[-1], "batch": b,
                "ms": time_ms(lambda: emb_ops.lookup_cuda(table, ids), flush),
                "warm_ms": time_ms(lambda: emb_ops.lookup_cuda(table, ids), None),
                "plain_ms": time_ms(lambda: emb_ops.lookup_take(table, ids), flush),
                "library_ms": time_ms(lambda: torch.index_select(table, 0, ids_long), flush),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            })
            looked = (torch.randn(b, FIELDS, K + 1, generator=gen) * 0.3).to(dtype).to(dev)
            v = looked[..., :K]
            nbytes = b * FIELDS * K * es + b * es
            flops = 3 * b * FIELDS * K
            bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
            rows.append({
                "name": "fm_cross", "dtype": str(dtype).split(".")[-1], "batch": b,
                "ms": time_ms(lambda: fm_ops.fm_cross_cuda(v), flush),
                "warm_ms": time_ms(lambda: fm_ops.fm_cross_cuda(v), None),
                "plain_ms": time_ms(lambda: fm_ops.fm_cross_xla(v), flush),
                "library_ms": None,
                "bound_ms": bound * 1e3,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
                else "operations",
            })
    return floor, rows


KERNELS = {
    "embedding_lookup": ("rectpu_torch/kernels/csrc/embedding_lookup.cu",
                         "rectpu/ops/embedding.py:70"),
    "fm_cross": ("rectpu_torch/kernels/csrc/fm.cu", "rectpu/ops/fm.py:271"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the full results here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    gpu = gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {gpu}")

    # 1. build
    t0 = time.perf_counter()
    for r in build.build():
        print(f"build: {r.name} -> {r.path.name} in {r.seconds:.2f} s")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {r.name}: {line.strip()}")
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s")

    # 2. kernels against their plain versions
    gen = torch.Generator().manual_seed(args.seed)
    errs = check_kernels(dev, gen)

    # 3. the main path, bf16 then fp32
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    main_path = {}
    try:
        for label, compute, sizes in (("deep_fm_k64_bf16", "bfloat16", (1, 64, 512)),
                                      ("deep_fm_k64_fp32", None, (1, 64, 512))):
            export_dir = make_export(work / label, compute, gen)
            main_path[label] = serve_and_check(export_dir, label, args.seed, sizes)
            res = main_path[label]
            print(f"main path {label}: launches {res['launches']} over "
                  f"{res['metrics']['batches_dispatched']} device batches, max |logit - CPU| "
                  f"{res['max_logit_err']:.3g}; /predict median ms "
                  f"{ {n: round(t, 3) for n, t in res['latency_ms'].items()} }; one "
                  f"{res['breakdown_ms']['instances']}-instance request outside HTTP, median "
                  f"ms: parse {res['breakdown_ms']['parse']:.3f}, encode "
                  f"{res['breakdown_ms']['encode']:.3f}, forward "
                  f"{res['breakdown_ms']['forward']:.3f} [{gpu}]")
            prof = res["forward_profile"]
            busy = ("not measured (no device events in the trace)"
                    if prof["device_busy_ms"] is None else f"{prof['device_busy_ms']:.4f} ms")
            print(f"profile {label}: {prof['instances']}-row forward {prof['wall_ms']:.3f} ms "
                  f"wall, device busy {busy}; top kernels "
                  f"{[(k, round(t, 4)) for k, t in prof['top_kernels_ms']]} [{gpu}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 4. times
    floor, rows = time_kernels(dev, gen)
    print(f"time: floor of this method (a one-element add) {floor:.4f} ms [{gpu}]")
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"time: {r['name']} {r['dtype']} B={r['batch']}: kernel {r['ms']:.4f} ms "
              f"(L2-warm {r['warm_ms']:.4f} ms), "
              f"plain {r['plain_ms']:.4f} ms, library {lib} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) [{gpu}]")

    bf16 = main_path["deep_fm_k64_bf16"]["launches"]
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        head = next(r for r in rows if r["name"] == name and r["dtype"] == "bfloat16"
                    and r["batch"] == 4096)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": bf16[name], "max_abs_err": errs[name],
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "dtype": "bfloat16", "batch": 4096,
        })
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"gpu": gpu, "torch": torch.__version__, "kernels": kernels, "times": rows,
             "floor_ms": floor,
             "main_path": main_path, "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
