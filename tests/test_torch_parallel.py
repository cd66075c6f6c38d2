"""The port's mesh, collectives, EP exchanges, plan and row placement
(``rectpu_torch/parallel/``) against the unsharded lookup and against
rectpu's ``parallel/`` on its 8 virtual CPU devices; and the two pieces of
sharding outside ``parallel/``: the loader's shards and the hash dropout
rows of a rank's batch slice, against rectpu's.

The ranks are spawned processes over Gloo (``tests/torch_mp_worker.py``),
one group a mesh shape (1x2 and 2x2), each running every case once; rectpu
runs here on the same mesh shape, with the same numpy-seeded inputs, so rank
r holds the batch slice rectpu gives the device at mesh position (r // M,
r % M).

Tolerances:
  - forwards of the exact exchanges: bitwise (one owner's row plus zeros);
  - the flat ``lin`` and every table gradient: rtol 1e-5, atol 1e-6, the
    fp32 bound of another order of sums (a row's cotangents summed per
    shard, then over 'data'; ``lin`` summed per shard, then over 'model');
  - bf16 wire on bf16-exact tables: bitwise; bf16 wire: rtol 2^-8;
    int8 wire: |err| <= amax/254 per row, its gradient rtol 2^-7, atol 0.02,
    rectpu's bounds (``tests/test_comm_compress.py``), and within 1e-6 of
    rectpu's own compressed values, which round the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import rectpu.parallel.placement as jax_placement
from rectpu.parallel import make_mesh as jax_make_mesh
from rectpu_torch.parallel import placement
from rectpu_torch.parallel.plan import ParallelPlan
from torch_ep_checks import (GRAD_ATOL, GRAD_RTOL, assemble, check_against_rectpu,
                             check_compressed, unsharded)
from torch_mp_worker import LOOKUP_CASES, run_ranks
from torch_mp_worker import fake_mesh as _fake_mesh

MESHES = [(1, 2), (2, 2)]
EXACT = [c[0] for c in LOOKUP_CASES if c[5] is None and c[6] is None]


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def ranks(request, tmp_path_factory):
    d, m = request.param
    return (d, m), run_ranks("lookups", d * m, tmp_path_factory.mktemp("ranks"),
                             num_data=d, num_model=m)


@pytest.mark.parametrize("name", EXACT)
def test_exchange_equals_unsharded_lookup(ranks, name):
    """Every exact exchange, flat or not, xla or mxu backward, has_lin both:
    the forward is the unsharded gather bit for bit and the table gradient
    the unsharded one (another order of fp32 sums)."""
    mesh, results = ranks
    got, ref = assemble(mesh, results, name), unsharded(name)
    for k in ("out", "emb"):
        if k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    if "lin" in ref:
        np.testing.assert_allclose(got["lin"], ref["lin"], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(got["grad"], ref["grad"], rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("name", ["2d", "1d"])
def test_exchange_against_rectpu(ranks, name):
    """The same exchange in rectpu on the same mesh gives the same rows and
    table gradient (the other cases: ``tests/test_torch_ep_rectpu.py``)."""
    check_against_rectpu(ranks, name)


@pytest.mark.parametrize("name", ["2d_bf16_exact", "dedup_bf16_exact", "2d_bf16", "dedup_bf16",
                                  "dedup_int8", "2d_flat_bf16_mxu", "dedup_flat_int8"])
def test_compressed_wire(ranks, name):
    """bf16 is exact on bf16 values; bf16 and int8 stay within rectpu's
    bounds (rectpu's own compressed exchanges are held in
    ``tests/test_torch_ep_rectpu.py``); int8's bf16 backward stays within
    rectpu's gradient bound."""
    check_compressed(ranks, name, against_rectpu=False)


# -- collectives -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def collective_ranks(tmp_path_factory):
    return run_ranks("collectives", 2, tmp_path_factory.mktemp("coll"))


def _jax_collective(name):
    """rectpu's lax call under shard_map on a 1x2 mesh: (y, dx) per rank,
    with the ranks' inputs and cotangents of torch_mp_worker."""
    mesh = jax_make_mesh(1, 2)
    x = np.concatenate([np.arange(24, dtype=np.float32).reshape(8, 3) + 100 * r
                        for r in range(2)])
    fn = {"all_gather": lambda v: jax.lax.all_gather(v, "model", axis=0, tiled=True),
          "psum_scatter": lambda v: jax.lax.psum_scatter(v, "model", scatter_dimension=0,
                                                          tiled=True),
          "all_to_all": lambda v: jax.lax.all_to_all(v, "model", 0, 0, tiled=True)}[name]
    f = shard_map(fn, mesh=mesh, in_specs=P("model"), out_specs=P("model"))
    y, vjp = jax.vjp(f, jnp.asarray(x))
    ny = y.shape[0] // 2
    g = np.concatenate([np.arange(ny * 3, dtype=np.float32).reshape(ny, 3) * (r + 1)
                        for r in range(2)])
    (dx,) = vjp(jnp.asarray(g))
    return np.split(np.asarray(y), 2), np.split(np.asarray(dx), 2)


@pytest.mark.parametrize("name", ["all_gather", "psum_scatter", "all_to_all"])
def test_collective_transposes_match_jax(collective_ranks, name):
    """Each autograd collective's forward and backward equal JAX's lax call
    and its transpose under shard_map, rank for rank."""
    ys, dxs = _jax_collective(name)
    for r, got in enumerate(collective_ranks):
        np.testing.assert_array_equal(got[name]["y"], ys[r])
        np.testing.assert_array_equal(got[name]["dx"], dxs[r])


def test_psum_forward_sums_and_transposes_to_identity(collective_ranks):
    """psum sums the ranks' values; its transpose (JAX's pvary of an
    axis-invariant cotangent) hands each rank its own cotangent."""
    x = [np.arange(24, dtype=np.float32).reshape(8, 3) + 100 * r for r in range(2)]
    for r, got in enumerate(collective_ranks):
        np.testing.assert_array_equal(got["psum"]["y"], x[0] + x[1])
        np.testing.assert_array_equal(got["psum"]["dx"],
                                      np.arange(24, dtype=np.float32).reshape(8, 3) * (r + 1))


def test_world_size_must_match_the_mesh(collective_ranks):
    assert "needs 1 processes, the process group has 2" in collective_ranks[0]["mesh_mismatch"]


# -- the plan ----------------------------------------------------------------------------


def test_plan_validation():
    """rectpu's checks (``plan.py:64-112``, ``tests/test_comm_compress.py:120``),
    the tensor-parallel towers' among them: a plan with ``tp_mlp`` is built
    over model shards and refused without them."""
    mesh = _fake_mesh(2, 4)
    with pytest.raises(ValueError):
        ParallelPlan.create(2, 4, table_rows=64, ep_mode="2d", ep_comm_compress="int8",
                            mesh=mesh)
    with pytest.raises(ValueError):
        ParallelPlan.create(2, 4, table_rows=64, ep_mode="1d", ep_comm_compress="bf16",
                            mesh=mesh)
    with pytest.raises(ValueError, match="ep_peer_capacity"):
        ParallelPlan.create(2, 4, table_rows=64, ep_mode="2d", ep_peer_capacity=8, mesh=mesh)
    assert ParallelPlan.create(2, 4, table_rows=64, tp_mlp=True, mesh=mesh).tp_mlp
    with pytest.raises(ValueError, match="tp_mlp requires num_model_shards > 1"):
        ParallelPlan.create(2, 1, table_rows=64, tp_mlp=True, mesh=_fake_mesh(2, 1))
    with pytest.raises(ValueError, match="needs 8 processes"):
        ParallelPlan.create(2, 4, table_rows=64)  # no process group is up
    plan = ParallelPlan.create(2, 4, table_rows=64, ep_mode="dedup", ep_comm_compress="int8",
                               ep_peer_capacity=8, scatter_impl="auto", mesh=mesh)
    assert plan.scatter_impl == "xla" and plan.ep and plan.batch_2d
    assert hasattr(plan.lookup_fn, "flat_variant")
    dp = ParallelPlan.create(2, 1, table_rows=64, mesh=_fake_mesh(2, 1))
    assert not dp.ep and dp.lookup_fn is None and dp.batch_axis is dp.mesh.data


@pytest.mark.parametrize("rank", range(8))
def test_param_sharding_rules(rank):
    """rectpu's ``_param_spec``: a 2-D leaf of table_rows rows (the table and
    its optimizer-state twins) keeps rank (d, m)'s rows [m*V/M, (m+1)*V/M);
    everything else is replicated; the batch slice of 2d/dedup is rank r's,
    of 1d data row d's."""
    from rectpu_torch.features.schema import ml_100k_feature_set
    from rectpu_torch.models import DeepFMModel, TowerConfig

    cfg = TowerConfig(feature_set=ml_100k_feature_set(), embedding_size=4, table_padding=32)
    model = DeepFMModel(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    v = cfg.padded_buckets
    for mode in ("2d", "1d"):
        plan = ParallelPlan.create(2, 4, table_rows=v, ep_mode=mode, mesh=_fake_mesh(2, 4, rank))
        sh = plan.shard_params({"params": params, "opt": {"m": {"emb": params["emb"]}}})
        m = rank % 4
        np.testing.assert_array_equal(sh["params"]["emb"], params["emb"][m * v // 4:(m + 1) * v // 4])
        np.testing.assert_array_equal(sh["opt"]["m"]["emb"], sh["params"]["emb"])
        assert sh["params"]["mlp"][0]["kernel"] is params["mlp"][0]["kernel"]
        assert sh["params"]["linear"]["w"] is params["linear"]["w"]  # 1-D: replicated
        batch = {"x": np.arange(16)}
        got = plan.shard_batch(batch)["x"].numpy()
        pos = rank if mode == "2d" else rank // 4
        n = 8 if mode == "2d" else 2
        np.testing.assert_array_equal(got, np.arange(16)[pos * 16 // n:(pos + 1) * 16 // n])


# -- placement ---------------------------------------------------------------------------


def _field_info():
    from rectpu_torch.features.schema import ml_100k_feature_set

    fs = ml_100k_feature_set()
    return (tuple(int(o) for o in fs.offsets), tuple(fs.field_sizes)), fs.total_buckets


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("skew", ["uniform", "zipf"])
def test_placement_equals_rectpu_bit_for_bit(n_shards, skew):
    """The port's copy of placement.py gives rectpu's permutation, loads,
    capacity and relabeled table, bit for bit."""
    field_info, total = _field_info()
    padded = -(-total // 128) * 128
    rng = np.random.default_rng(n_shards)
    if skew == "uniform":
        counts = rng.integers(0, 1000, size=padded)
    else:
        counts = np.floor(1e6 / (rng.permutation(padded) + 1.0) ** 1.2)
    cat_ids = rng.integers(0, total, size=(512, 26))
    for mod in (placement, jax_placement):
        assert mod.count_row_frequencies(cat_ids, padded).dtype == np.int64
    np.testing.assert_array_equal(placement.count_row_frequencies(cat_ids, padded),
                                  jax_placement.count_row_frequencies(cat_ids, padded))
    perm = placement.frequency_permutation(counts, field_info, n_shards, padded)
    np.testing.assert_array_equal(
        perm, jax_placement.frequency_permutation(counts, field_info, n_shards, padded))
    np.testing.assert_array_equal(placement.shard_load(counts, perm, n_shards),
                                  jax_placement.shard_load(counts, perm, n_shards))
    assert placement.suggest_peer_capacity(counts, n_shards, padded, 64 * 26) == \
        jax_placement.suggest_peer_capacity(counts, n_shards, padded, 64 * 26)
    table = rng.normal(size=(padded, 5)).astype(np.float32)
    np.testing.assert_array_equal(placement.relabel_table_rows(table, perm),
                                  jax_placement.relabel_table_rows(table, perm))



# -- the loader's shards -----------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [2, 4])
def test_loader_shards_equal_rectpus(num_shards):
    """Each shard's train blocks (index and materialized batches, across an
    epoch boundary and a resume from a DataState) and its eval rows are
    rectpu's (``rectpu/io/loader.py:166-252``), and the blocks in shard order
    are the single-process batch."""
    from rectpu.io.loader import CsvDataset as JaxCsvDataset
    from rectpu_torch.io.loader import CsvDataset, DataState

    rng = np.random.default_rng(num_shards)
    ids = rng.integers(0, 50, size=(103, 4)).astype(np.int32)
    labels = rng.integers(0, 2, size=103).astype(np.float32)
    ours = CsvDataset.from_arrays(ids, labels)
    theirs = JaxCsvDataset.from_arrays(ids, labels)
    state = DataState(epoch=1, index=40, seed=3)
    for st in (None, state):
        single = ours.train_index_batches(8 * num_shards, state=st, seed=3)
        gens = [(ours.train_index_batches(8, state=st, seed=3, shard_id=i, num_shards=num_shards),
                 theirs.train_index_batches(8, state=st, seed=3, shard_id=i,
                                            num_shards=num_shards))
                for i in range(num_shards)]
        for _ in range(30):  # several epochs of 103 rows
            rows, st_single = next(single)
            blocks = []
            for mine, ref in gens:
                (got, st_got), (want, st_want) = next(mine), next(ref)
                np.testing.assert_array_equal(got, want)
                assert (st_got.epoch, st_got.index) == (st_want.epoch, st_want.index)
                blocks.append(got)
            np.testing.assert_array_equal(np.concatenate(blocks), rows)
            assert (st_got.epoch, st_got.index) == (st_single.epoch, st_single.index)
    b0 = next(ours.train_batches(8, seed=3, shard_id=1, num_shards=num_shards))[0]
    r0 = next(theirs.train_batches(8, seed=3, shard_id=1, num_shards=num_shards))[0]
    for k in r0:
        np.testing.assert_array_equal(b0[k], r0[k])
    for i in range(num_shards):
        got = list(ours.eval_batches(16, shard_id=i, num_shards=num_shards))
        want = list(theirs.eval_batches(16, shard_id=i, num_shards=num_shards))
        assert len(got) == len(want) == len(list(ours.eval_batches(16, shard_id=0,
                                                                   num_shards=num_shards)))
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("width", [256, 7])
@pytest.mark.parametrize("row_offset", [0, 4, 12])
def test_hash_dropout_rows_of_the_global_mask(width, row_offset):
    """A rank's slice of the batch draws rows [row_offset, row_offset + B_loc)
    of rectpu's global mask, bit for bit (both the two-draws-a-hash form of
    an even width and the per-element form of an odd one)."""
    from rectpu.models.base import hash_dropout_mask as jax_mask
    from rectpu_torch.models.base import hash_dropout_mask

    seed = 0x9E3779B9 + width
    want = np.asarray(jax_mask(jnp.uint32(seed), (16, width), 0.3))[row_offset:row_offset + 4]
    got = hash_dropout_mask(seed, (4, width), 0.3, row_offset=row_offset).numpy()
    np.testing.assert_array_equal(got, want)
