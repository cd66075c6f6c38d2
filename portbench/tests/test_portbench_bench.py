"""portbench on the CPU at a tiny size: the configurations build, the counts
equal hand counts, the reference agrees with the port's step, the check
fails the control and planted faults, nothing of JAX or rectpu loads, and a
new configuration, traffic mix and metric are found by name.

    python -m pytest portbench/tests -q        (from the checkout's root)
"""

import json
import math
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import (check, control, counts, generate, program, run, spec,  # noqa: E402
                       tracing, weights)

BENCH = spec.benchmark()
# every configuration on the Zipf traffic at a tiny batch, the xDeepFM one
# included (it has no cell yet): the port's plain path at its widths is the
# witness that the reference is right there
TARGETS = [("dlrm-mlperf-criteo1tb", "zipf-b8192"), ("xdeepfm-criteo-kaggle", "zipf-b8192")]
X4 = "dlrm-1tb.zipf-b8192.x4"
# limits at the tiny size: the port reads under 2e-5 here, the TF32 control over 2e-4
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "update_gap": 1e-4}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # sums in one order: the tiny readings repeat
    yield
    torch.set_num_threads(n)


def config_file(name):
    return dict(json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text()),
                name=name)


def tiny(config, traffic_name, batch=64):
    conf = config_file(config)
    conf["sparse_rows"] = [min(r, 300) for r in conf["sparse_rows"]]
    conf["flags"] = conf["flags"] + ["--steps-per-loop", "4"]
    traffic = dict(spec.traffic(traffic_name), rows=1024, batch_size=batch)
    cell = {"name": f"{config}.{traffic_name}", "config": config, "traffic": traffic_name,
            "chips": 1}
    return cell, conf, traffic


def tiny_run(target, seed=5, patch=None, trace=False):
    cell, conf, traffic = tiny(*target)
    return run.run_cell(BENCH, cell, seed, 0.05, trace, device="cpu", conf=conf,
                        traffic=traffic, limits=TINY_LIMITS, patch=patch)


def tiny_x4():
    cell = spec.cell(BENCH, X4)
    _, conf, traffic = tiny(cell["config"], cell["traffic"], batch=256)
    return cell, conf, traffic


@pytest.mark.parametrize("config,traffic", TARGETS)
def test_config_builds_tiny_with_the_models_leaves(config, traffic, tmp_path):
    _, conf, traffic = tiny(config, traffic)
    ref = spec.reference(conf["family"])
    data = generate.make_dataset(traffic, conf["sparse_rows"], conf["dense_features"], 3, "cpu")
    prog = program.build(conf, traffic, ref, data, 3, "cpu", str(tmp_path / "job"))
    # the model's own init makes the leaves the reference names, shape for shape
    from rectpu_torch.convert import flatten_tree

    own = flatten_tree(prog.model.init(torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(s[0]) for k, s in prog.specs.items()}
    assert prog.trainer.dispatch == "scan"  # batch 64: "auto" scans
    for key in ("sparse_rows", "dense_features", "reduced", "assumed", "departures", "source"):
        assert key in config_file(config)


def test_benchmark_entries_name_their_files():
    for c in BENCH["configs"]:
        assert spec.config(BENCH, c["name"])["reduced"] == c["reduced"]
        assert spec.limits(c["name"])
    for w in BENCH["workloads"]:
        assert callable(spec.generator(spec.traffic(w["traffic"])["generator"]).make_dataset)
        assert spec.cell_metrics(BENCH, w["name"], "per_layer")
    for m in BENCH["per_layer"]:
        assert callable(spec.metric(m["name"]).read)


def test_flops_by_hand():
    dlrm = spec.reference("dlrm").flops_per_example(config_file("dlrm-mlperf-criteo1tb"))
    bottom = 2 * (13 * 512 * 2 + 512 * 256 * 3 + 256 * 128 * 3)  # no input gradient of the data
    top = 2 * 3 * (479 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1)
    assert dlrm == {"mlp": bottom + top, "interaction": 2 * 351 * 128 * 3}
    assert 14.4e6 < sum(dlrm.values()) < 14.5e6
    xd = spec.reference("xdeep_fm").flops_per_example(config_file("xdeepfm-criteo-kaggle"))
    cin = 4 * 2 * 10 * 39 * (39 * 200 + 200 * 200 + 200 * 200)
    assert xd == {"mlp": 2 * 3 * (390 * 400 + 400 * 400 + 400 * 1), "cin": cin,
                  "cin_out": 2 * 600 * 3}


def test_bytes_by_hand():
    assert counts.lookup_bytes(8, 2, 4, 5) == 8 * 2 * 4 + 5 * 4 * 4 + 8 * 2 * 4 * 4
    assert counts.table_grad_bytes(8, 2, 4, 5) == 8 * 2 * (4 * 4 + 4) + 5 * 4 * 4
    leaves = {"emb": (10, 40), "top/0/kernel": (3, 6)}
    assert counts.optimizer_bytes("SGD", leaves, ("emb",), 5) == 3 * 4 * (5 * 4) + 3 * 4 * 6
    assert counts.optimizer_bytes("Adam", leaves, ("emb",), 5) == 7 * 4 * (40 + 6)
    assert counts.bound_s(flops=165e12, nbytes=1.0) == pytest.approx(1.0)
    assert counts.bound_s(nbytes=3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("target", TARGETS, ids=[t[0] for t in TARGETS])
def test_reference_agrees_with_the_port_tiny(target):
    res = tiny_run(target)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"train_examples_per_s", "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "check"


def _state_unchanged(prog):
    """The step leaves the parameters and the optimizer's state as they were."""
    opt = prog.trainer.optimizer

    class Unchanged:
        def update(self, grads, state, params, scalars=None):
            pass

    frozen = Unchanged()
    for attr in ("name", "init", "beta1", "beta2", "epsilon"):
        if hasattr(opt, attr):
            setattr(frozen, attr, getattr(opt, attr))
    prog.trainer.optimizer = frozen


def _half_batch(prog):
    loss = prog.trainer.loss

    def half(batch, train, step=0, seed32=None):
        n = batch["labels"].shape[0] // 2
        return loss({k: v[:n] for k, v in batch.items()}, train, step, seed32)

    prog.trainer.loss = half


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("target", TARGETS, ids=[t[0] for t in TARGETS])
def test_check_fails_a_broken_step(target, fault):
    res = tiny_run(target, patch=fault)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("target", TARGETS, ids=[t[0] for t in TARGETS])
def test_control_fails_and_the_port_passes_tiny(target):
    cell, conf, traffic = tiny(*target)
    r = control.readings(BENCH, cell, 7, "cpu", conf=conf, traffic=traffic)
    assert check.judge(r["program"], TINY_LIMITS), r
    assert not check.judge(r["control_tf32"], TINY_LIMITS), r
    assert not check.judge(r["fault_half_batch"], TINY_LIMITS), r


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_four_ranks_on_gloo(fault):
    """The four-card cell's whole run on four Gloo ranks at a tiny size;
    with the ranks' gradient sum left out, ``correct`` is false."""
    cell, conf, traffic = tiny_x4()
    given = {"conf": conf, "traffic": traffic, "limits": TINY_LIMITS}
    if fault:
        given["patch"] = control.FAULTS[fault]
    res, failed = run.run_ranks(4, (X4, 5, 0.05, False, "cpu", 0.0, given))
    assert failed == [] and res["device"]["count"] == 4
    assert res["correct"] is (fault is None), res["check"]


def _jax_on_rank_1(prog):
    """Rank 1 alone loads a module named ``jax`` (an empty stand-in)."""
    if prog.plan.process_index == 1:
        sys.modules["jax"] = types.ModuleType("jax")


def test_import_guard_checks_every_rank(capsys):
    """A forbidden module that only rank 1's process loads fails that rank,
    and the run prints no result."""
    cell, conf, traffic = tiny_x4()
    given = {"conf": conf, "traffic": traffic, "limits": TINY_LIMITS, "patch": _jax_on_rank_1}
    res, failed = run.run_ranks(4, (X4, 5, 0.05, False, "cpu", 0.0, given))
    assert failed == [1] and res["correct"], res["check"]
    assert "jax" not in sys.modules
    assert run.report(res, failed) != 0
    assert capsys.readouterr().out == ""


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -10 - 2 ** -12])
    from portbench.refstep import tf32_round

    assert tf32_round(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -1.0 - 2 ** -10]


def test_import_guard(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rectpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rectpu.models", sys)
    assert run.forbidden_modules() == ["rectpu"]
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["jaxlib", "rectpu"]


def test_a_run_loads_no_jax_or_rectpu():
    code = ("import portbench.run as r, portbench.control, portbench.program, "
            "rectpu_torch.trainers.dlrm, rectpu_torch.trainers.xdeep_fm, "
            "rectpu_torch.train.loop; print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_main_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    conf = json.loads((pb / "configs" / "dlrm-mlperf-criteo1tb.json").read_text())
    (pb / "configs" / "dlrm-new.json").write_text(json.dumps(dict(conf, embedding_size=64)))
    traffic = json.loads((pb / "traffic" / "zipf-b8192.json").read_text())
    (pb / "traffic" / "zipf-b2048.json").write_text(json.dumps(dict(traffic, batch_size=2048)))
    (pb / "limits" / "dlrm-new.json").write_text(json.dumps(TINY_LIMITS))
    (pb / "metrics" / "loop.new_counter.py").write_text("def read(ctx):\n    return 42.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="dlrm-new",
                                 file="portbench/configs/dlrm-new.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="dlrm-new.zipf-b2048",
                                   config="dlrm-new", traffic="zipf-b2048"))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="loop.new_counter",
                                   workloads=["dlrm-new.zipf-b2048"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = spec.benchmark(tmp_path)
    cell = spec.cell(b, "dlrm-new.zipf-b2048")
    assert spec.config(b, cell["config"], tmp_path)["embedding_size"] == 64
    assert spec.traffic(cell["traffic"], tmp_path)["batch_size"] == 2048
    assert spec.limits(cell["config"], tmp_path) == TINY_LIMITS
    names = [m["name"] for m in spec.cell_metrics(b, cell["name"], "per_layer")]
    assert "loop.new_counter" in names and "collective_ms_per_step" not in names
    assert spec.metric("loop.new_counter", tmp_path).read(None) == 42.0
    assert spec.reference("dlrm", tmp_path).lookup_width({"embedding_size": 64}) == 64


def test_a_new_generator_is_found_by_name(tmp_path):
    """A traffic file that names a generator file added beside the others
    is drawn by it, with no edit to a file that is there."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    body = ("import torch\n\n\n"
            "def make_dataset(traffic, field_rows, num_dense, seed, device):\n"
            "    n = traffic['rows'] - traffic.get('short', 0)\n"
            "    g = torch.Generator(device=device).manual_seed(seed)\n"
            "    ids = torch.randint(0, sum(field_rows), (n, len(field_rows)), generator=g,\n"
            "                        dtype=torch.int32)\n"
            "    return {'cat_ids': ids, 'num_vals': torch.zeros(n, num_dense),\n"
            "            'labels': torch.zeros(n)}\n")
    (tmp_path / "portbench" / "generators" / "uniform.py").write_text(body)
    traffic = {"generator": "uniform", "rows": 64, "batch_size": 32}
    a = generate.make_dataset(traffic, [5, 7], 3, 11, "cpu", root=tmp_path)
    b = generate.make_dataset(traffic, [5, 7], 3, 11, "cpu", root=tmp_path)
    assert a["cat_ids"].shape == (64, 2) and a["num_vals"].shape == (64, 3)
    assert torch.equal(a["cat_ids"], b["cat_ids"]) and a["cat_ids"].max() < 12
    # a set that is not the traffic's size is refused
    with pytest.raises(ValueError, match="made"):
        generate.make_dataset(dict(traffic, short=1), [5, 7], 3, 11, "cpu", root=tmp_path)


def test_batch_rows_follow_the_loader():
    from rectpu_torch.io.loader import CsvDataset

    n, b, seed = 96, 32, 2 ** 33 + 5
    ds = CsvDataset.from_arrays(np.zeros((n, 1), np.int32), np.zeros(n, np.float32))
    it = ds.train_index_batches(b, seed=seed)
    for step in range(7):  # two epochs and a bit
        rows, _ = next(it)
        assert np.array_equal(rows, generate.batch_rows(seed, n, b, step))


def test_dataset_is_the_seeds():
    traffic = dict(spec.traffic("zipf-b8192"), rows=8192)
    a = generate.make_dataset(traffic, [50, 3, 7000], 13, 2 ** 40 + 1, "cpu")
    b = generate.make_dataset(traffic, [50, 3, 7000], 13, 2 ** 40 + 1, "cpu")
    c = generate.make_dataset(traffic, [50, 3, 7000], 13, 2 ** 40 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["cat_ids"], c["cat_ids"])
    ids = a["cat_ids"]
    assert ids[:, 0].max() < 50 and 50 <= ids[:, 1].min() and ids[:, 1].max() < 53
    assert ids[:, 2].min() >= 53 and ids[:, 2].max() < 7053
    # Zipf: the hottest row of a field takes a large share, not 1/7000
    top = torch.bincount(ids[:, 2] - 53).max().item() / traffic["rows"]
    assert 0.05 < top < 0.3
    assert 0.2 < a["labels"].mean().item() < 0.3 and (a["num_vals"] >= 0).all()


def test_weights_made_again_by_block(monkeypatch):
    monkeypatch.setattr(weights, "BLOCK", 7)
    spec_ = ((30, 4), ("trunc_normal", 0.5))
    full = weights.make_leaf(spec_, "emb", 9, "cpu")
    rows = torch.tensor([0, 6, 7, 20, 29])
    assert torch.equal(weights.rows_of(spec_, "emb", 9, rows, "cpu"), full[rows])
    assert full.abs().max() <= 1.0 and full.std() > 0.2
    g = weights.make_leaf(((5, 3), ("glorot", 5, 3)), "k", 9, "cpu")
    assert g.abs().max() <= math.sqrt(6 / 8)
    tree = weights.nest({"a": 1, "top/0/kernel": 2, "top/1/bias": 3, "lin/w": 4})
    assert tree == {"a": 1, "top": [{"kernel": 2}, {"bias": 3}], "lin": {"w": 4}}


def test_trace_attribution():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 0, "dur": 100,
         "tid": 1},
        {"ph": "X", "cat": "python_function", "name": "rectpu_torch/models/base.py(200): _dot",
         "ts": 1, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 2, "dur": 5, "tid": 1,
         "args": {"Sequence number": 7, "Fwd thread id": 0}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 3, "dur": 1,
         "tid": 1, "args": {"correlation": 11}},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32", "ts": 10, "dur": 20,
         "tid": 9, "args": {"correlation": 11}},
        {"ph": "X", "cat": "cpu_op", "name": "autograd::engine::evaluate_function: MmBackward0",
         "ts": 40, "dur": 10, "tid": 2, "args": {"Sequence number": 7, "Fwd thread id": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 42, "dur": 1,
         "tid": 2, "args": {"correlation": 12}},
        {"ph": "X", "cat": "kernel", "name": "ampere_sgemm_128x64", "ts": 50, "dur": 30,
         "tid": 9, "args": {"correlation": 12}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 85, "dur": 10, "tid": 1},
    ]
    seg = tracing.parse(ev, steps=2)
    fwd, bwd = seg.ops
    assert fwd.from_file("models/base.py") and fwd.ops == ("aten::mm",)
    assert not bwd.frames and bwd.from_file("models/base.py") and bwd.under("MmBackward0")
    assert seg.window_s == pytest.approx(100e-6) and seg.busy_s == pytest.approx(50e-6)
    assert seg.aten_ops == 2 and seg.per_step_s(lambda o: True) == pytest.approx(25e-6)
    gaps = dict(seg.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(50e-6)
