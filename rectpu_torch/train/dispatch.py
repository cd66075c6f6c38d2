"""How a training loop's steps reach the device: the port of rectpu's
``TrainConfig.dispatch_mode`` (``rectpu/train/loop.py:55-61, 268-272``).

  - "pipelined": every step is dispatched on its own (eager PyTorch), with
    its scalars as host numbers (``StepScalars``): the dropout seed, the
    optimizer's step counter ``t`` and Adam's bias-corrected rate ``lr_t``.
  - "scan": a loop's k steps read their scalars (``ScalarBlock``) and their
    batches (``BatchBlock``) from fixed device buffers, filled once per
    loop, through a device counter that each step advances, and write their
    losses into a fixed [k] buffer. On the card one step runs as a CUDA
    graph (``StepGraph``), captured after a few eager warm-up steps and
    replayed k times a loop: the counterpart of rectpu's one ``lax.scan``
    dispatch over a stacked super-batch. On the CPU the same step function
    runs eagerly, with the same scalars read from the buffers.
  - "auto": pipelined at ``batch_size >= 2048``, else scan (rectpu's rule).

The rule is the same under a ParallelPlan, on the CPU and on the card. A
step under a plan crosses ranks only through the collectives of
``parallel/collectives.py``, and a CUDA graph cannot hold one that copies
through host memory (Gloo) or that another process has to join at replay.
So on the card ``StepGraph`` captures such a step piecewise: segment graph
0, collective 0, segment graph 1, ..., each collective cutting the open
segment where the step calls it (in the forward, or in the backward on the
autograd engine's device thread), and a replay runs the segments in order
with each collective eager between them, on the input and output buffers
its capture recorded. ``CollectiveLog`` records the same sequence without a
graph (the CPU tests hold it equal at every step and on every rank).

Every per-step value is computed on the host by the same code in both modes
(``step_seed32``, ``adam_lr_t``), so the two modes train bit for bit alike.
A graph bakes Python numbers into its kernels, so in scan mode each of them
is a 0-d device tensor: the seed as a ``models.base.DeviceSeed`` (the hash
masks read its tensor; threefry dropout draws from generators that
``ThreefrySites`` reseeds on the host before every step), ``t`` as int64 and
``lr_t`` as fp32.
"""

from __future__ import annotations

import copy
import gc
import warnings

import numpy as np
import torch

from rectpu_torch.kernels import launch_counts
from rectpu_torch.models.base import DeviceSeed, ThreefrySites, step_seed32
from rectpu_torch.ops.fused_adam import adam_lr_t, adam_lr_t_values
from rectpu_torch.parallel import collectives
from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DISPATCH_MODES = ("scan", "pipelined", "auto")
PIPELINED_MIN_BATCH = 2048  # "auto" pipelines from this batch size up (rectpu's rule)
WARMUP_STEPS = 3  # eager steps before a step is captured
MAX_RATES = 8  # distinct Adam (lr, beta1, beta2) a scan step may read


def resolve_dispatch_mode(mode: str, batch_size: int) -> str:
    """"scan" or "pipelined" for ``TrainConfig.dispatch_mode`` ``mode``
    (rectpu's ``Trainer._dispatch_mode``, whatever the plan and device).
    Raises ValueError on any other mode."""
    if mode not in DISPATCH_MODES:
        raise ValueError(f"dispatch_mode must be one of {'|'.join(DISPATCH_MODES)}, "
                         f"got {mode!r}")
    if mode == "auto":
        return "pipelined" if batch_size >= PIPELINED_MIN_BATCH else "scan"
    return mode


def _counters(state):
    """Every optimizer step counter (a dict's int ``"t"`` leaf) in a state tree."""
    if not isinstance(state, dict):
        return
    t = state.get("t")
    if isinstance(t, torch.Tensor) and t.dim() == 0 and not t.is_floating_point():
        yield state
    for key, node in state.items():
        if key != "t":
            yield from _counters(node)


def opt_counter(state) -> int:
    """The optimizer's step counter (0 for a state without one). A state of
    several optimizers (``per_subtree``) holds one per counting optimizer;
    they step together, and counters that disagree raise."""
    values = {int(d["t"]) for d in _counters(state)}
    if len(values) > 1:
        raise ValueError(f"the optimizer state's step counters disagree: {sorted(values)}")
    return values.pop() if values else 0


def set_opt_counter(state, t: int) -> None:
    """Set every step counter of ``state`` to ``t`` (host int32 tensors)."""
    for d in _counters(state):
        d["t"] = torch.tensor(t, dtype=torch.int32)


class _Placed:
    """Where the leaves a step updates sit in rectpu's global arrays:
    ``placement`` (the Trainer sets ``ParallelPlan.sr_index`` under a plan)
    maps a leaf's full key path and tensor to a ``utils.hash32.GlobalIndex``,
    or None for a leaf held whole; ``sr_index`` reads it (None without a
    placement). ``within(top)`` is a copy for an optimizer of the subtree
    ``top``, whose keys are the paths below it."""

    placement = None

    def sr_index(self, key: str, leaf):
        return None if self.placement is None else self.placement(key, leaf)

    def within(self, top: str):
        sub = copy.copy(self)
        outer = self.placement
        if outer is not None:
            sub.placement = lambda key, leaf: outer(f"{top}/{key}" if key else top, leaf)
        return sub


class StepScalars(_Placed):
    """One step's scalars as host numbers: ``seed32`` (the dropout seed,
    ``step_seed32``, or None) and ``t`` (the optimizer's step counter after
    the step's increment). ``lr_t`` is Adam's bias-corrected rate, its fp32
    value as a Python float; ``commit`` stores ``t`` in an optimizer state
    that counts steps."""

    def __init__(self, seed32, t: int):
        self.seed32, self.t = seed32, t

    @classmethod
    def after(cls, state, seed32=None) -> StepScalars:
        """The scalars of the step that follows ``state``."""
        return cls(seed32, opt_counter(state) + 1)

    def lr_t(self, lr: float, beta1: float, beta2: float) -> float:
        return float(adam_lr_t(self.t, lr, beta1, beta2))

    def commit(self, state: dict) -> None:
        if "t" in state:
            state["t"] = torch.tensor(self.t, dtype=torch.int32)


class DeviceScalars(_Placed):
    """One step's scalars read from a ``ScalarBlock`` at its counter: the
    ``StepScalars`` interface with 0-d device tensors (``seed32`` a
    ``DeviceSeed``). ``commit`` does nothing: the loop sets the state's
    counters on the host once per loop (``set_opt_counter``)."""

    def __init__(self, block: ScalarBlock):
        self._block = block
        self._rates: dict = {}
        self.seed32 = DeviceSeed(block.read(block.ints, 0), lambda s: s, block.sites)
        self.t = block.read(block.ints, 1)

    def lr_t(self, lr: float, beta1: float, beta2: float) -> torch.Tensor:
        key = (lr, beta1, beta2)
        if key not in self._rates:
            self._rates[key] = self._block.rate(key)
        return self._rates[key]

    def commit(self, state: dict) -> None:
        pass


def _upload(dst: torch.Tensor, host: np.ndarray) -> None:
    """Copy ``host`` into the fixed tensor ``dst`` without waiting for the
    card: from pinned memory, which the caching host allocator does not hand
    out again until the copies that read it have run, so a later loop never
    overwrites a block whose copy is still pending."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    if dst.is_cuda:
        src = src.pin_memory()
    dst.copy_(src, non_blocking=dst.is_cuda)


class ScalarBlock:
    """The scalars of a loop's steps in fixed device buffers of ``rows``
    (``steps_per_loop``) slots: ``ints`` [rows, 2] int64 holds each step's
    seed32 and ``t``, ``rates`` [rows, MAX_RATES] fp32 each Adam rate
    ``lr_t`` that a step asked for (``rate``; a new one is registered at its
    first request, before any capture). ``load`` fills a loop's slots on the
    host and zeroes ``counter``, the slot of the step that runs next;
    ``view`` reads the step's slot, ``advance`` moves the counter on."""

    def __init__(self, rows: int, device, seed: int):
        self.rows, self.seed = rows, seed
        self.sites = ThreefrySites()
        self.ints = torch.zeros(rows, 2, dtype=torch.int64, device=device)
        self.rates = torch.zeros(rows, MAX_RATES, dtype=torch.float32, device=device)
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.rate_keys: list = []
        self.frozen = False  # a captured graph reads the buffers: no new rate
        self._loop = (0, 0, 0)  # (first step, counter before it, steps) of the loaded loop

    def host_seeds(self) -> list:
        step0, _, k = self._loop
        return [step_seed32(self.seed, step0 + i) for i in range(k)]

    def load(self, step0: int, t0: int, k: int) -> None:
        """Fill slots [0, k) for steps step0 ... step0 + k - 1, whose
        optimizer counters are t0 + 1 ... t0 + k."""
        if not 0 < k <= self.rows:
            raise ValueError(f"a loop of {k} steps in a block of {self.rows}")
        self._loop = (step0, t0, k)
        ints = np.zeros((self.rows, 2), np.int64)
        ints[:k, 0] = self.host_seeds()
        ints[:k, 1] = t0 + 1 + np.arange(k)
        _upload(self.ints, ints)
        self._load_rates()
        self.counter.zero_()

    def _load_rates(self) -> None:
        _, t0, k = self._loop
        rates = np.zeros((self.rows, MAX_RATES), np.float32)
        for col, (lr, b1, b2) in enumerate(self.rate_keys):
            rates[:k, col] = adam_lr_t_values(range(t0 + 1, t0 + 1 + k), lr, b1, b2)
        _upload(self.rates, rates)

    def read(self, buf: torch.Tensor, col: int) -> torch.Tensor:
        """The 0-d value of column ``col`` at the counter's slot."""
        return buf.select(1, col).index_select(0, self.counter).reshape(())

    def rate(self, key: tuple) -> torch.Tensor:
        if key not in self.rate_keys:
            if self.frozen:
                raise RuntimeError(f"an Adam rate {key} first asked for after the step's CUDA "
                                   "graph was captured")
            if len(self.rate_keys) == MAX_RATES:
                raise ValueError(f"a step asks for more than {MAX_RATES} Adam rates")
            self.rate_keys.append(key)
            self._load_rates()
        return self.read(self.rates, self.rate_keys.index(key))

    def view(self) -> DeviceScalars:
        return DeviceScalars(self)

    def advance(self) -> None:
        self.counter.add_(1)


class BatchBlock:
    """A loop's batches in fixed device buffers of ``rows`` slots: with a
    resident train set (``resident``, its tensors on the device) the batches'
    row indices as one [rows, B] int64 block, rectpu's ``train_chunk_idx``;
    else the host batches stacked per key, [rows, B, ...]. ``load`` copies a
    loop's batches in; ``batch(counter)`` is the batch at the counter's slot,
    as the pipelined loop stages it."""

    def __init__(self, rows: int, device, resident: dict | None):
        self.rows, self.device, self.resident = rows, device, resident
        self.bufs: dict = {}

    def load(self, items: list) -> None:
        if not 0 < len(items) <= self.rows:
            raise ValueError(f"a loop of {len(items)} batches in a block of {self.rows}")
        stacked = ({"idx": np.stack(items)} if self.resident is not None else
                   {key: np.stack([b[key] for b in items]) for key in items[0]})
        for key, host in stacked.items():
            buf = self.bufs.get(key)
            if buf is None:
                buf = torch.zeros((self.rows, *host.shape[1:]),
                                  dtype=torch.from_numpy(host[:1]).dtype, device=self.device)
                self.bufs[key] = buf
            if tuple(buf.shape[1:]) != host.shape[1:]:
                raise ValueError(f"batch {key!r} of shape {host.shape[1:]} in a block of "
                                 f"{tuple(buf.shape[1:])}")
            _upload(buf[:host.shape[0]], host)

    def batch(self, counter: torch.Tensor) -> dict:
        if self.resident is not None:
            idx = self.bufs["idx"].index_select(0, counter).reshape(-1)
            return {key: v.index_select(0, idx) for key, v in self.resident.items()}
        return {key: buf.index_select(0, counter)[0] for key, buf in self.bufs.items()}


class CollectiveLog:
    """A collectives controller (``parallel/collectives.set_controller``)
    that runs every collective as it comes and records it as (op, axis name,
    input shape, dtype) in ``calls``: the sequence that a replay of a
    piecewise capture runs. A context manager that routes the process's
    collectives here while open."""

    def __init__(self):
        self.calls: list = []

    def collective(self, op, x, out, axis):
        self.calls.append((op, axis.name, tuple(x.shape), str(x.dtype)))
        return collectives.launch(op, x, out, axis)

    def __enter__(self) -> CollectiveLog:
        collectives.set_controller(self)
        return self

    def __exit__(self, *exc) -> None:
        collectives.set_controller(None)


class _Segments:
    """The capture controller of a step: each collective ends the open
    segment's capture, is recorded with its input and its output (tensors
    of the graphs' pool, which the record keeps alive, so no segment reuses
    them; detached, since the output of a differentiated collective carries
    its autograd node), and opens the next segment, all on the capture
    stream of the thread that calls it; the step then goes on with the
    output, which the replays fill. Capture runs nothing, the collectives
    included. The segments share one memory pool and are captured in
    "relaxed" mode, which lets a capture end on another thread than the one
    that began it (the autograd engine's device thread runs the backward's
    collectives). A step with no collective is one segment."""

    def __init__(self, sites: ThreefrySites):
        self.sites = sites
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: list = []
        self.collectives: list = []  # (op, x, out, axis) after graphs[i]

    def begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen, _ in self.sites.sites:
            graph.register_generator_state(gen)
        graph.capture_begin(pool=self.pool, capture_error_mode="relaxed")
        self.graphs.append(graph)

    def end(self) -> None:
        with warnings.catch_warnings():
            # a segment between two collectives with no work between them (the
            # flat exchange's two sums) is empty, which PyTorch warns of as if
            # the capture had missed its stream; its replay launches nothing
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            self.graphs[-1].capture_end()

    def collective(self, op, x, out, axis):
        self.end()
        self.collectives.append((op, x.detach(), out.detach(), axis))
        self.begin()
        return out


class StepGraph:
    """Runs ``fn`` (one training step that reads ``block``) once per call.
    On the CPU eagerly. On the card the first ``warmup`` calls run eagerly on
    a side stream (training steps like any other, which also build the
    kernels); the next call captures one call of ``fn`` as CUDA graphs, with
    the threefry generators of ``block.sites`` registered, and every call
    from then on is one replay. The capture is cut at each collective
    (``_Segments``; a step under a plan): ``graphs`` holds the segments and
    ``collectives`` the collectives between them, which a replay runs
    eagerly. A capture that fails raises.

    Replays run no Python, so the wrappers' launch counts (``LaunchCount``)
    do not see them: ``per_replay`` holds the launches each counter saw
    during the capture, over all segments, and every replay adds them to
    the counters' ``replayed`` (the capture's own to ``captured``, since
    capturing launches nothing). ``replays`` counts the replays."""

    def __init__(self, fn, block: ScalarBlock, device, warmup: int = WARMUP_STEPS):
        self.fn, self.block = fn, block
        self.cuda = torch.device(device).type == "cuda"
        self.warmup = warmup
        self.graphs: list = []
        self.collectives: list = []
        self.per_replay: list = []
        self.replays = 0
        self._stream = None

    @property
    def captured(self) -> bool:
        return bool(self.graphs)

    def __call__(self) -> None:
        if not self.cuda:
            self.fn()
        elif self.graphs:
            self._replay()
        elif self.warmup > 0:
            self.warmup -= 1
            self._side_stream().wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                self.fn()
            torch.cuda.current_stream().wait_stream(self._stream)
        else:
            self._capture()
            self._replay()

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def _capture(self) -> None:
        self.block.frozen = self.block.sites.frozen = True
        before = {c: c.value for c in launch_counts()}
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        stream = self._side_stream()
        segments = _Segments(self.block.sites)
        with torch.cuda.stream(stream):
            segments.begin()
            collectives.set_controller(segments)
            try:
                self.fn()
            finally:
                collectives.set_controller(None)
                segments.end()
        torch.cuda.current_stream().wait_stream(stream)
        self.per_replay = [(c, c.value - n) for c, n in before.items() if c.value != n]
        for c, n in self.per_replay:
            c.captured += n
        self.graphs, self.collectives = segments.graphs, segments.collectives
        logger.info("step captured: %d graph segments around %d collectives",
                    len(self.graphs), len(self.collectives))
        self.block.sites.reseed()  # the step whose call captured it runs by the replay

    def _replay(self) -> None:
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(self.collectives):
                collectives.launch(*self.collectives[i])
        self.replays += 1
        for c, n in self.per_replay:
            c.replayed += n
