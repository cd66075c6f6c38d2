"""Kernel auto-selection: the port of ``rectpu/ops/autotune.py``.

Run once at trainer start (``--autotune``): time the interchangeable
implementations at the working shapes and pin the winners, so that the
"auto" dispatchers resolve to them. rectpu times XLA forms against its Pallas
kernels. On the card a plain PyTorch version may not stand on a path, so
this autotuner chooses only among the port's own hand-written kernels and
their launch geometry, and never pins a plain version or a library call:

  | rectpu's choice   | the port's candidates on the card              | pin          |
  | lookup            | ``embedding_lookup.cu``, timed once            | none         |
  | fm                | ``fm.cu`` 3-D, timed once                      | none         |
  | flat_scatter      | ``scatter_rows.cu``: its chunk length, 16 /    | ``_AUTO_CHUNK`` |
  |   + tile sweep    |   32 / 64 positions per warp                   |              |
  | fm_flat           | "xla": ``fm.cu`` 3-D on the [B, F, K] view;    | ``_FLAT_AUTO`` |
  |                   | "pallas": the flat kernels of ``fm.cu``        |              |
  | interact          | ``interaction.cu``, exact products ("pallas") | ``_INTERACT_AUTO`` |
  |                   | or rounded ones ("pallas-mxu")                 |              |

A choice with one kernel has nothing to pin: its pick is the route that ran,
"cuda" (or "plain" on the CPU). rectpu's "xla" interaction computes the same
exact products as "pallas" and launches the same kernel, so it is not timed
twice. The flat FM routes are timed through ``fm_cross_flat_dispatch``, the
function the pin steers.

Pins are keyed "cuda" / "cpu" where rectpu keys "tpu" / "other". On the CPU,
where the port runs only the plain versions, the same candidates time those
(the CPU tests use this). Timing: on the card the median CUDA-event time of
warm launches (``utils.timing.event_ms``); on the CPU the host-clock median.
A candidate is timed forward plus backward (rectpu's ``value_and_grad``,
:147-151), so the forward is part of what is chosen.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from rectpu_torch.device import device_key, resolve_device
from rectpu_torch.ops import embedding as emb_ops
from rectpu_torch.ops import fm as fm_ops
from rectpu_torch.ops import interaction as int_ops
from rectpu_torch.ops import scatter_rows as scatter_ops
from rectpu_torch.utils.logging import get_logger
from rectpu_torch.utils.timing import event_ms

logger = get_logger(__name__)

SCATTER_CHUNKS = (16, 32, 64)  # positions of the sorted stream per warp
CUDA_ITERS = 50  # event pairs per candidate on the card
CPU_REPS = 3  # host-clock repetitions per candidate on the CPU


def _timer(dev: torch.device):
    """Seconds of one call of ``fn`` on ``dev``: the median of warm CUDA-event
    pairs on the card, of host-clock repetitions on the CPU."""
    def time_s(fn) -> float:
        if dev.type == "cuda":
            return event_ms(fn, None, iters=CUDA_ITERS) / 1e3
        fn()
        times = []
        for _ in range(CPU_REPS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)
    return time_s


def _fwd_bwd(fn, x: torch.Tensor):
    """A call of ``fn`` on ``x`` and the gradient of the sum of its fp32
    output (rectpu's value_and_grad)."""
    def run():
        y = x.detach().requires_grad_()
        (g,) = torch.autograd.grad(fn(y).float().sum(), y)
        return g
    return run


def _field_ids(rng, batch: int, field_info) -> np.ndarray:
    offsets, sizes = field_info
    return np.stack([offsets[f] + rng.integers(0, sizes[f], size=batch)
                     for f in range(len(sizes))], axis=1).astype(np.int32)


def _autotune_flat(batch, num_fields, k, vocab_rows, field_info, dev, route, time_s,
                   results):
    """The flat path's choices: the scatter's chunk at the lookup backward's
    update stream, the flat FM route and the interaction's products."""
    key = device_key(dev)
    rng = np.random.default_rng(1)

    # 1. the scatter's chunk length at the stream the flat backward scatters:
    #    every (batch row, field) id into the [V, K+1] table
    ids = torch.from_numpy(_field_ids(rng, batch, field_info).reshape(-1)).to(dev)
    upd = torch.from_numpy(rng.normal(size=(ids.shape[0], k + 1)).astype(np.float32)).to(dev)
    for chunk in SCATTER_CHUNKS:
        results[f"scatter_chunk/{chunk}"] = time_s(
            lambda chunk=chunk: scatter_ops.scatter_rows_dense(ids, upd, vocab_rows,
                                                               chunk=chunk))
    best_chunk = min(SCATTER_CHUNKS, key=lambda c: results[f"scatter_chunk/{c}"])
    scatter_ops.set_auto_chunk(best_chunk)

    # 2. the flat FM's two routes at the production dtype (bf16)
    v2 = torch.from_numpy(rng.normal(size=(batch, num_fields * k)).astype(np.float32)).to(
        torch.bfloat16).to(dev)
    fm_flat_impls = ("xla", "pallas")
    for name in fm_flat_impls:
        results[f"fm_flat/{name}"] = time_s(_fwd_bwd(
            lambda x, name=name: fm_ops.fm_cross_flat_dispatch(x, num_fields, k, impl=name), v2))
    best_fm_flat = min(fm_flat_impls, key=lambda n: results[f"fm_flat/{n}"])
    fm_ops.set_flat_auto_impl(best_fm_flat, key)

    # 3. DLRM's pairwise interaction from the flat activations
    int_impls = ("pallas", "pallas-mxu")
    for name in int_impls:
        results[f"interact_flat/{name}"] = time_s(_fwd_bwd(
            lambda x, name=name: int_ops.interact_flat(x, num_fields, k, impl=name), v2))
    best_int = min(int_impls, key=lambda n: results[f"interact_flat/{n}"])
    int_ops.set_interact_auto_impl(best_int, key)

    return {"flat_scatter": route, "scatter_chunk": best_chunk,
            "fm_flat": best_fm_flat, "interact": best_int}


def autotune(batch: int, num_fields: int, embedding_size: int, vocab_rows: int,
             include_grad: bool = True, field_info=None, flat: bool = True,
             device=None) -> dict:
    """Time the candidates at the working shapes on ``device`` (default
    ``cuda``) and pin the winners for its device type.

    Returns rectpu's keys (``lookup``, ``fm``, and with ``field_info`` and
    ``flat`` also ``flat_scatter``, ``fm_flat``, ``interact``), the port's
    ``scatter_chunk`` and ``timings_s``, the seconds of each candidate keyed
    ``<choice>/<candidate>``. The lookup, the 3-D FM and the flat scatter have
    one kernel each: their pick is the route, "cuda" (or "plain" on the CPU),
    and the first two are timed as ``lookup/<route>`` and ``fm/<route>``."""
    dev = resolve_device(device)
    key = device_key(dev)
    route = "cuda" if key == "cuda" else "plain"
    time_s = _timer(dev)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        rng.normal(size=(vocab_rows, embedding_size)).astype(np.float32)).to(dev)
    if field_info is not None:
        ids_np = _field_ids(rng, batch, field_info)
    else:
        ids_np = rng.integers(0, vocab_rows, size=(batch, num_fields)).astype(np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    v = torch.from_numpy(
        rng.normal(size=(batch, num_fields, embedding_size)).astype(np.float32)).to(dev)

    results = {}
    t = time_s(lambda: emb_ops.lookup(table, ids))
    if include_grad:
        t += time_s(_fwd_bwd(lambda tb: emb_ops.lookup(tb, ids), table))
    results[f"lookup/{route}"] = t

    t = time_s(lambda: fm_ops.fm_cross(v))
    if include_grad:
        t += time_s(_fwd_bwd(fm_ops.fm_cross, v))
    results[f"fm/{route}"] = t

    picks = {"lookup": route, "fm": route}
    if flat and field_info is not None:
        picks.update(_autotune_flat(batch, num_fields, embedding_size, vocab_rows, field_info,
                                    dev, route, time_s, results))

    logger.info("autotune on %s: %s (%s)", key, picks,
                {name: f"{1e3 * t:.3f}ms" for name, t in sorted(results.items())})
    picks["timings_s"] = results
    return picks
