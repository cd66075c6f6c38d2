"""The port's dispatch modes (``TrainConfig.dispatch_mode``, ``train/dispatch.py``)
and the rest of rectpu's timing and profiling, on the CPU.

  - The mode's resolution against rectpu's ``Trainer._dispatch_mode``
    ("auto" at batch 2047 and 2048), a bad mode, and the same rule for a
    Trainer under a plan, on the CPU and on the card.
  - "scan" (its steps read their batches and scalars from fixed buffers
    through a device counter; on the CPU the step runs eagerly, the function
    a CUDA graph captures on the card) against "pipelined", bit for bit in
    every step's loss, the final parameters and the optimizer state: DeepFM
    K=4 [16, 16], dropout 0.1 in both impls, batch 64, 50 steps in loops of
    20, 20 and 10; the sparse fast step; every optimizer of the registry
    and the reduced-precision Adam and Adagrad slots; each family with its
    default optimizer; a save at step 20 and a restore, equal to the
    straight run; and, in 2 Gloo ranks, under a data-parallel plan and an
    EP plan with the fast step (``torch_mp_worker.dispatch_results``).
  - Both modes against rectpu's scan and pipelined runs on the same data
    from one rectpu checkpoint (the packages draw their inits from
    different generators), dropout off, with rectpu's tolerance for its own
    two modes (``tests/test_train_e2e.py:164-187``: rtol 1e-5, atol 1e-6 on
    auc, average_loss and accuracy).
  - The device-side scalars bit for bit against the host path: ``lr_t`` and
    the seeds for t in 1 ... 64 and 2**31 - 1, hash masks and stochastic
    rounding with a tensor seed against an int seed, the seed functions on a
    ``DeviceSeed``, fused Adam's plain version with tensor ``t`` / ``lr_t``.
  - ``fetch_sync``, ``chained_slope_s`` / ``_ms`` and ``StepTimer`` against
    rectpu's on fake clocks, ``annotate`` in a trace, ``merge_states`` and
    ``psum_state`` against rectpu's, the ``make_sparse_deepfm_step`` alias.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.features.schema import ml_100k_feature_set as jax_feature_set
from rectpu.io.loader import CsvDataset as JaxCsvDataset
from rectpu.models import DeepFMModel as JaxDeepFM
from rectpu.models import TowerConfig as JaxTowerConfig
from rectpu.train import metrics as jax_metrics
from rectpu.train.checkpoint import Checkpointer as JaxCheckpointer
from rectpu.train.loop import TrainConfig as JaxTrainConfig
from rectpu.train.loop import Trainer as JaxTrainer
from rectpu.utils import profiling as jax_profiling
from rectpu.utils import timing as jax_timing
from rectpu_torch.convert import flat_params, flatten_tree, opt_state_tree
from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.io.loader import CsvDataset
from rectpu_torch.models import MODEL_REGISTRY, DeepFMModel, TowerConfig
from rectpu_torch.models.base import (DeviceSeed, ThreefrySites, _layer_seed,
                                      hash_dropout_mask, step_seed32, tower_seed32)
from rectpu_torch.ops.fused_adam import fused_adam_plain, stochastic_round_bf16
from rectpu_torch.train import dispatch, fast_step
from rectpu_torch.train import metrics as metrics_lib
from rectpu_torch.train.dispatch import (ScalarBlock, StepScalars, opt_counter,
                                         resolve_dispatch_mode)
from rectpu_torch.train.fast_step import make_sparse_step
from rectpu_torch.train.loop import TrainConfig, Trainer
from rectpu_torch.train.optimizers import BF16_SR, adagrad, adam, bf16_param_store, get_optimizer
from rectpu_torch.utils import profiling, timing
from torch_mp_worker import DISPATCH_PLANS, metric_inputs, run_ranks

T_VALUES = list(range(1, 65)) + [2**31 - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    paths = write_synthetic_dataset(tmp_path_factory.mktemp("dispatch_data"), train_rows=2000,
                                    test_rows=300, seed=3)
    fs = ml_100k_feature_set()
    return paths, CsvDataset(paths["train"], fs), CsvDataset(paths["test"], fs)


def _deep_fm(**kw):
    cfg = dict(embedding_size=4, hidden_units=(16, 16), dropout=0.1, dropout_impl="hash")
    cfg.update(kw)
    return DeepFMModel(TowerConfig(feature_set=ml_100k_feature_set(), **cfg))


def _run(data, job, mode, model, optimizer=None, fast=None, steps=50, restore=False,
         **config):
    """Train ``model`` through ``Trainer.train_and_evaluate``: batch 64,
    loops of 20 -> (trainer, metrics)."""
    _, train_ds, eval_ds = data
    cfg = dict(batch_size=64, train_steps=steps, steps_per_loop=20, seed=7,
               save_checkpoints_steps=10**6, dispatch_mode=mode)
    cfg.update(config)
    trainer = Trainer(model, optimizer or model.default_optimizer(), train_ds, eval_ds, job,
                      TrainConfig(**cfg), fast_step=fast(model) if fast else None)
    return trainer, trainer.train_and_evaluate(restore=restore)


def _state(trainer) -> dict:
    if trainer.fast_step is not None:
        return flatten_tree({k: v for k, v in trainer.opt_state.items()})
    return flatten_tree(opt_state_tree(trainer.opt_state))


def _assert_same_run(a, b):
    """Two trainers trained bit for bit alike: every step's loss, the
    parameters and the optimizer state."""
    assert a.step_losses == b.step_losses
    pa, pb = flat_params(a.model), flat_params(b.model)
    assert pa.keys() == pb.keys()
    for key in pa:
        assert torch.equal(pa[key].detach(), pb[key].detach()), key
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(torch.as_tensor(sa[key]), torch.as_tensor(sb[key])), key


def _scan_and_pipelined(data, tmp_path, make_model, **kw):
    runs = {mode: _run(data, tmp_path / mode, mode, make_model(), **kw)[0]
            for mode in ("scan", "pipelined")}
    assert runs["scan"].dispatch == "scan" and runs["scan"].step_graph is not None
    assert runs["pipelined"].dispatch == "pipelined" and runs["pipelined"].step_graph is None
    _assert_same_run(runs["scan"], runs["pipelined"])
    return runs


# -- the mode ----------------------------------------------------------------------------


def _planned_dispatch(tmp_path, mode: str, batch: int, device: str) -> str:
    """The dispatch of a Trainer under a (stand-in) plan on ``device``; no
    step runs, so "cuda" needs no card."""
    plan = types.SimpleNamespace(mesh=types.SimpleNamespace(device=torch.device(device)),
                                 lookup_fn=None, batch_index=0, batch_shards=1, tp_mlp=False)
    model = _deep_fm()
    trainer = Trainer(model, model.default_optimizer(), None, None, tmp_path / device,
                      TrainConfig(batch_size=batch, dispatch_mode=mode), plan=plan)
    assert trainer.device.type == device
    return trainer.dispatch


@pytest.mark.parametrize("mode", ["scan", "pipelined", "auto"])
@pytest.mark.parametrize("batch", [1, 64, 2047, 2048, 8192])
def test_mode_resolves_as_rectpus(mode, batch, tmp_path):
    want = JaxTrainer._dispatch_mode(types.SimpleNamespace(
        config=JaxTrainConfig(batch_size=batch, dispatch_mode=mode)))
    assert resolve_dispatch_mode(mode, batch) == want
    assert _planned_dispatch(tmp_path, mode, batch, "cpu") == want


def test_auto_switches_at_batch_2048():
    assert resolve_dispatch_mode("auto", 2047) == "scan"
    assert resolve_dispatch_mode("auto", 2048) == "pipelined"
    assert TrainConfig().dispatch_mode == "auto"


def test_a_bad_mode_raises(tmp_path):
    with pytest.raises(ValueError, match="dispatch_mode must be one of scan"):
        resolve_dispatch_mode("graph", 64)
    model = _deep_fm()
    with pytest.raises(ValueError, match="dispatch_mode must be one of scan"):
        Trainer(model, model.default_optimizer(), None, None, tmp_path,
                TrainConfig(dispatch_mode="Scan"))


@pytest.mark.parametrize("batch", [64, 4096])
def test_a_plan_on_the_card_pipelines_and_refuses_scan(batch, tmp_path):
    """A plan on the card follows rectpu's batch rule, as one on the CPU:
    "auto" scans below batch 2048 and pipelines from it, "scan" and
    "pipelined" are taken as asked (the sharded step is captured piecewise,
    ``StepGraph``)."""
    for b, auto in ((batch, "scan" if batch < 2048 else "pipelined"), (2047, "scan"),
                    (2048, "pipelined")):
        assert _planned_dispatch(tmp_path, "auto", b, "cuda") == auto
        assert _planned_dispatch(tmp_path, "scan", b, "cuda") == "scan"
        assert _planned_dispatch(tmp_path, "pipelined", b, "cuda") == "pipelined"


# -- scan against pipelined ----------------------------------------------------------------


@pytest.mark.parametrize("placement", ["device", "host"])
@pytest.mark.parametrize("impl", ["hash", "threefry"])
def test_scan_equals_pipelined_deep_fm(impl, placement, data, tmp_path):
    """Both dropout impls, the batches gathered from the resident train set
    (a [k, B] index block a loop under scan) or staged from the host
    (stacked [k, B, ...] a loop under scan)."""
    runs = _scan_and_pipelined(data, tmp_path, lambda: _deep_fm(dropout_impl=impl),
                               data_placement=placement)
    assert len(runs["scan"].step_losses) == 50
    assert int(runs["scan"].opt_state["t"]) == 50
    assert runs["scan"].step_graph.block.rate_keys == [(1e-3, 0.9, 0.999)]  # lr_t read there
    sites = runs["scan"].step_graph.block.sites.sites
    assert len(sites) == (2 if impl == "threefry" else 0)  # one generator a hidden layer


@pytest.mark.parametrize("slots", ["f32", "bf16_sr"])
def test_scan_equals_pipelined_fast_step(slots, data, tmp_path):
    def fast(model):
        return make_sparse_step(model, learning_rate=1e-3,
                                slot_dtype="bfloat16_sr" if slots == "bf16_sr" else "float32",
                                scatter_backend="dma" if slots == "f32" else "xla")

    runs = _scan_and_pipelined(data, tmp_path, lambda: _deep_fm(packed_linear=True,
                                                                table_padding=2048),
                               fast=fast)
    assert int(runs["scan"].opt_state["t"]) == 50


@pytest.mark.parametrize("name", ["Adagrad", "Adam", "Ftrl", "RMSProp", "SGD"])
def test_scan_equals_pipelined_every_optimizer(name, data, tmp_path):
    _scan_and_pipelined(data, tmp_path, _deep_fm, steps=30,
                        optimizer=get_optimizer(name, learning_rate=0.01))


@pytest.mark.parametrize("case", ["adam_bf16_fused", "adagrad_bf16_sr", "bf16_store"])
def test_scan_equals_pipelined_reduced_precision(case, data, tmp_path):
    """The optimizers whose stochastic rounding reads the step counter:
    Adam's bf16 m and SR v with the table's fused sweep and a bf16 master,
    Adagrad's SR accumulator, and Adam under a bf16 parameter store."""
    model_kw, opt = {}, None
    if case == "adam_bf16_fused":
        model_kw = dict(table_dtype="bfloat16", packed_linear=True)
        opt = adam(1e-3, slot_dtype={"m": torch.bfloat16, "v": BF16_SR}, fused_leaves=("table",))
    elif case == "adagrad_bf16_sr":
        opt = adagrad(0.05, slot_dtype=BF16_SR)
    else:
        model_kw = dict(compute_dtype="bfloat16")
        opt = bf16_param_store(adam(1e-3))
    _scan_and_pipelined(data, tmp_path, lambda: _deep_fm(**model_kw), steps=30, optimizer=opt)


@pytest.mark.parametrize("family", ["linear", "deep", "linear_deep", "dlrm", "xdeep_fm", "dcn",
                                   "autoint"])
def test_scan_equals_pipelined_every_family(family, data, tmp_path):
    """Linear (FTRL), DNN (Adagrad), Wide&Deep (FTRL + Adagrad) and the
    Adam zoo, each with its default optimizer."""
    kw = dict(embedding_size=4, hidden_units=(8,), dropout=0.1, dropout_impl="threefry")

    def make():
        return MODEL_REGISTRY[family](TowerConfig(feature_set=ml_100k_feature_set(), **kw))

    _scan_and_pipelined(data, tmp_path, make, steps=25)


def test_restore_carries_on_as_the_straight_run(data, tmp_path):
    """Scan, threefry dropout, Adam: 20 steps, a save, a restored run to 50,
    equal to the straight 50-step run in the losses after step 20, the
    parameters and the optimizer state (t included)."""
    straight, _ = _run(data, tmp_path / "straight", "scan", _deep_fm(dropout_impl="threefry"))
    _run(data, tmp_path / "split", "scan", _deep_fm(dropout_impl="threefry"), steps=20)
    resumed, _ = _run(data, tmp_path / "split", "scan", _deep_fm(dropout_impl="threefry"),
                      restore=True)
    assert len(resumed.step_losses) == 30
    straight.step_losses = straight.step_losses[20:]
    _assert_same_run(resumed, straight)


def test_scan_under_a_plan_runs_eagerly_on_the_cpu(tmp_path):
    """2 Gloo ranks: scan equals pipelined under a data-parallel plan and an
    EP plan with the fast step; and ``psum_state`` against rectpu's over 2
    devices."""
    ranks = run_ranks("dispatch", 2, tmp_path, tmp=str(tmp_path))
    for res in ranks:
        for name in DISPATCH_PLANS:
            scan, pipe = res[f"{name}_scan"], res[f"{name}_pipelined"]
            np.testing.assert_array_equal(scan["losses"], pipe["losses"])
            assert len(scan["losses"]) == 10
            for key, want in pipe["params"].items():
                np.testing.assert_array_equal(scan["params"][key], want, err_msg=key)
    states = [jax_metrics.update_state(jax_metrics.init_state(), *map(jnp.asarray, rows))
              for rows in metric_inputs(2)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *states)
    want = jax.pmap(lambda s: jax_metrics.psum_state(s, "b"), axis_name="b",
                    devices=jax.devices()[:2])(stacked)
    for res in ranks:
        for key, got in res["psum"].items():
            np.testing.assert_array_equal(got, np.asarray(want[key][0]), err_msg=key)


# -- against rectpu ------------------------------------------------------------------------


def test_both_modes_match_rectpus_scan_and_pipelined(data, tmp_path):
    paths, train_ds, eval_ds = data
    fs = jax_feature_set()
    jcfg = JaxTowerConfig(feature_set=fs, embedding_size=4, hidden_units=(16, 16))
    model_j = JaxDeepFM(jcfg)
    params = model_j.init(jax.random.PRNGKey(0))
    opt_j = model_j.default_optimizer()
    JaxCheckpointer(tmp_path / "init").save(0, {"params": params, "opt_state": opt_j.init(params)})
    init = str(tmp_path / "init" / "ckpt-0")
    j_train, j_eval = JaxCsvDataset(paths["train"], fs), JaxCsvDataset(paths["test"], fs)
    config = dict(batch_size=64, train_steps=100, steps_per_loop=50, eval_batch_size=64,
                  save_checkpoints_steps=10**6)
    metrics = {}
    for mode in ("scan", "pipelined"):
        model = JaxDeepFM(jcfg)
        trainer = JaxTrainer(model, model.default_optimizer(), j_train, j_eval,
                             tmp_path / f"rectpu_{mode}", JaxTrainConfig(dispatch_mode=mode,
                                                                         **config))
        trainer.warm_start_from = init
        metrics[f"rectpu_{mode}"] = trainer.train_and_evaluate(restore=False)
        model = _deep_fm(dropout=0.0)
        trainer = Trainer(model, model.default_optimizer(), train_ds, eval_ds,
                          tmp_path / f"port_{mode}", TrainConfig(dispatch_mode=mode, **config))
        trainer.warm_start_from = init
        metrics[f"port_{mode}"] = trainer.train_and_evaluate(restore=False)
        assert trainer.dispatch == mode
    assert metrics["port_scan"] == metrics["port_pipelined"]
    for port in ("port_scan", "port_pipelined"):
        for ref in ("rectpu_scan", "rectpu_pipelined"):
            for key in ("auc", "average_loss", "accuracy"):
                assert np.isclose(metrics[port][key], float(metrics[ref][key]), rtol=1e-5,
                                  atol=1e-6), (port, ref, key, metrics)


# -- the device-side scalars ----------------------------------------------------------------


def _bits(x) -> int:
    return int(torch.tensor(x, dtype=torch.float32).view(torch.int32))


def test_block_scalars_equal_the_host_scalars():
    """lr_t and the seeds read from a ScalarBlock at its counter, bit for bit
    the host path's, for t in 1 ... 64 and 2**31 - 1."""
    keys = [(1e-3, 0.9, 0.999), (0.05, 0.8, 0.99)]
    for t0, k in ((0, 64), (2**31 - 2, 1)):
        block = ScalarBlock(64, "cpu", seed=42)
        block.load(1000 + t0 % 7, t0, k)
        for i in range(k):
            view = block.view()
            host = StepScalars(step_seed32(42, 1000 + t0 % 7 + i), t0 + i + 1)
            assert int(view.t) == host.t and int(view.seed32.value) == host.seed32
            assert view.seed32.host(host.seed32) == host.seed32
            for key in keys:
                got = view.lr_t(*key)
                assert got.dtype == torch.float32 and got.dim() == 0
                assert _bits(float(got)) == _bits(host.lr_t(*key)), (t0 + i + 1, key)
            block.advance()
    assert [host for host in block.host_seeds()] == [step_seed32(42, 1000 + (2**31 - 2) % 7)]


def test_a_rate_after_capture_raises():
    block = ScalarBlock(4, "cpu", seed=0)
    block.load(0, 0, 4)
    block.view().lr_t(1e-3, 0.9, 0.999)
    block.frozen = True
    block.view().lr_t(1e-3, 0.9, 0.999)  # known: fine
    with pytest.raises(RuntimeError, match="captured"):
        block.view().lr_t(1e-2, 0.9, 0.999)


@pytest.mark.parametrize("seed", [0, 1, 0x7FEB352D, 2**31 - 1, 2**31, 2**32 - 1])
def test_seed_functions_and_hash_masks_with_a_tensor_seed(seed):
    """``_layer_seed`` / ``tower_seed32`` on a DeviceSeed, and hash masks of
    even and odd widths with a row offset, equal the int path's."""
    dev = DeviceSeed(torch.tensor(seed, dtype=torch.int64), lambda s: s, ThreefrySites())
    for i in range(3):
        for derived, want in ((_layer_seed(dev, i), _layer_seed(seed, i)),
                              (tower_seed32(dev, i + 1), tower_seed32(seed, i + 1))):
            assert int(derived.value) == want and derived.host(seed) == want
    both = _layer_seed(tower_seed32(dev, 2), 1)
    assert int(both.value) == both.host(seed) == _layer_seed(tower_seed32(seed, 2), 1)
    for shape in ((5, 16), (7, 9), (3, 4, 6)):
        for row_offset in (0, 5):
            got = hash_dropout_mask(dev.value, shape, 0.3, row_offset=row_offset)
            want = hash_dropout_mask(seed, shape, 0.3, row_offset=row_offset)
            assert torch.equal(got, want), (shape, row_offset)


@pytest.mark.parametrize("t", T_VALUES[::7] + [2**31 - 1])
def test_stochastic_rounding_with_a_tensor_seed(t):
    x = torch.from_numpy(np.random.default_rng(t % 1000).standard_normal((9, 13)).astype(
        np.float32))
    for seed in (t, t + (1 << 30)):
        got = stochastic_round_bf16(x, torch.tensor(seed, dtype=torch.int64))
        assert torch.equal(got.view(torch.int16), stochastic_round_bf16(x, seed).view(
            torch.int16))


@pytest.mark.parametrize("kinds", [("f32", "f32", "f32"), ("f32", "bf16", "bf16_sr"),
                                   ("bf16", "bf16_sr", "bf16_sr")])
def test_fused_adam_plain_with_tensor_t_and_lr_t(kinds):
    """The plain version with a 0-d int64 ``t`` and fp32 ``lr_t`` (what the
    kernel reads from device memory in a captured step) equals it with the
    int and the host float, for t in 1 ... 64 and 2**31 - 1."""
    rng = np.random.default_rng(1)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "bf16_sr": torch.bfloat16}

    def make(kind, scale=1.0, positive=False):
        a = rng.standard_normal((11, 7)).astype(np.float32) * scale
        return torch.from_numpy(np.abs(a) if positive else a).to(dt[kind])

    p, m, v = make(kinds[0]), make(kinds[1], 0.1), make(kinds[2], 0.01, positive=True)
    g = make("f32")
    opts = dict(lr=1e-3, m_sr=kinds[1] == "bf16_sr", v_sr=kinds[2] == "bf16_sr")
    for t in T_VALUES:
        lr_t = StepScalars(None, t).lr_t(1e-3, 0.9, 0.999)
        want = fused_adam_plain(p, m, v, g, t, **opts)
        got = fused_adam_plain(p, m, v, g, torch.tensor(t, dtype=torch.int64),
                               lr_t=torch.tensor(lr_t, dtype=torch.float32), **opts)
        for a, b in zip(got, want):
            assert torch.equal(a, b), t
    with pytest.raises(ValueError, match="lr_t"):
        fused_adam_plain(p, m, v, g, torch.tensor(3), **opts)


def test_optimizer_counters():
    opt = adam(1e-3)
    state = {"a": opt.init({"w": torch.zeros(3)}), "b": adagrad(0.1).init({"w": torch.zeros(3)}),
             "c": adagrad(0.1, slot_dtype=BF16_SR).init({"w": torch.zeros(3)})}
    assert opt_counter(state) == 0
    dispatch.set_opt_counter(state, 7)
    assert opt_counter(state) == 7 and int(state["a"]["t"]) == int(state["c"]["t"]) == 7
    state["c"]["t"] = torch.tensor(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="disagree"):
        opt_counter(state)
    assert StepScalars.after({"t": torch.tensor(4, dtype=torch.int32)}).t == 5


# -- timing and profiling ----------------------------------------------------------------


class _Clock:
    """A host clock that only the step function and the fetch advance."""

    def __init__(self, step_s, fetch_s, first_window_extra=0.0):
        self.now, self.step_s, self.fetch_s = 0.0, step_s, fetch_s
        self.extra, self.steps = first_window_extra, 0

    def __call__(self):
        return self.now

    def step(self, n_in_first_window):
        self.steps += 1
        self.now += self.step_s + (self.extra if self.steps <= n_in_first_window else 0.0)


@pytest.mark.parametrize("extra", [0.0, 0.5])
@pytest.mark.parametrize("repeats", [1, 3])
def test_chained_slope_matches_rectpus(extra, repeats, monkeypatch):
    """The two-point slope and, when host load makes the first window the
    slower one (``extra`` s a step in it), the positive fallback, against
    rectpu's on the same fake clock (each step 2 ms, each fetch 30 ms)."""
    out = {}
    for name, mod, x0, fetch in (("port", timing, torch.zeros(3), "cpu"),
                                 ("rectpu", jax_timing, jnp.zeros(3), None)):
        clock = _Clock(0.002, 0.030, extra)
        monkeypatch.setattr(mod.time, "perf_counter", clock)
        real_fetch = mod.fetch_sync

        def fetch_sync(x, real_fetch=real_fetch, clock=clock):
            real_fetch(x)
            clock.now += clock.fetch_s

        monkeypatch.setattr(mod, "fetch_sync", fetch_sync)

        def step_fn(x, clock=clock):
            clock.step(1 + 40)
            return x + 1

        out[name] = (mod.chained_slope_s(step_fn, x0, repeats=repeats),
                     mod.chained_slope_ms(step_fn, x0, repeats=repeats))
    assert out["port"] == out["rectpu"]
    assert out["port"][0] > 0
    if extra == 0.0:
        assert out["port"][0] == pytest.approx(0.002, rel=1e-9)


def test_fetch_sync_reads_the_first_leaf():
    seen = []

    class Leaf:
        def __init__(self, name):
            self.name = name

        def dim(self):
            return 1

        def reshape(self, *shape):
            return self

        def __getitem__(self, item):
            return self

        def cpu(self):
            seen.append(self.name)

    timing.fetch_sync({"b": Leaf("b"), "a": [Leaf("a0"), Leaf("a1")]})
    timing.fetch_sync(torch.arange(5.0))
    timing.fetch_sync(torch.tensor(2.0))
    assert seen == ["a0"]
    with pytest.raises(ValueError, match="iters"):
        timing.chained_slope_s(lambda x: x, torch.zeros(1), iters=(5, 5))


def test_step_timer_matches_rectpus(monkeypatch):
    clock = [100.0]
    timers = {}
    for name, mod in (("port", profiling), ("rectpu", jax_profiling)):
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
        timers[name] = mod.StepTimer(window=10)
    clock[0] += 2.5
    for t in timers.values():
        t.update(20, 640)
        t.update(5, 160)
    assert timers["port"].rates() == timers["rectpu"].rates() == {
        "steps_per_sec": 10.0, "examples_per_sec": 320.0, "ms_per_step": 100.0}
    assert timers["port"].elapsed == timers["rectpu"].elapsed == 2.5
    assert timers["port"].window == 10
    for t in timers.values():
        t.reset()
    assert timers["port"].rates() == timers["rectpu"].rates()


def test_annotate_names_a_region_in_the_trace(tmp_path):
    with profiling.trace(tmp_path) as capture:
        with profiling.annotate("rectpu_torch_step"):
            with profiling.annotate("rectpu_torch_inner"):
                torch.ones(8).add_(1.0)
    text = capture.path.read_text()
    assert "rectpu_torch_step" in text and "rectpu_torch_inner" in text


def test_merge_states_matches_rectpus():
    rows = metric_inputs(2, seed=21)
    port = [metrics_lib.update_state(metrics_lib.init_state(), *map(torch.from_numpy, r))
            for r in rows]
    ref = [jax_metrics.update_state(jax_metrics.init_state(), *map(jnp.asarray, r))
           for r in rows]
    got, want = metrics_lib.merge_states(*port), jax_metrics.merge_states(*ref)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                   err_msg=key)
    assert metrics_lib.finalize(got)["count"] == float(want["count"])


def test_make_sparse_deepfm_step_is_the_fast_step():
    assert fast_step.make_sparse_deepfm_step is make_sparse_step
