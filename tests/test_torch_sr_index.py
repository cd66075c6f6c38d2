"""Stochastic rounding keyed on the global flat index under a ParallelPlan.

rectpu rounds a sharded leaf's update with ``iota`` over the global array
(``rectpu/train/optimizers.py:65``, under GSPMD), so an element's noise does
not depend on the rank that holds it. The port keys it the same way from
the leaf's place in its global array (``utils.hash32.GlobalIndex``, from
``ParallelPlan.sr_index``):

  - the port's rounding of a shard with its index equals the matching slice
    of rectpu's rounding of the global array, bit for bit: rows of a table,
    columns of a tower kernel, a block of a 1-D bias;
  - the fused Adam sweep's plain version on a row shard (bf16 m, bf16-SR v,
    a bf16 parameter) equals the slice of the global sweep, and its kernel's
    index base (``index_base``) is the shard's first global element; a
    column cut has none and raises;
  - ``ParallelPlan.sr_index`` places every leaf of a DeepFM and a DLRM tree, with and
    without the tensor-parallel towers, as ``shard_params`` cuts it, on
    every rank of 1x2 and 2x2 meshes;
  - a ``per_subtree`` optimizer's scalars name the leaves by their full
    paths, and a step's scalars without a placement key on the whole leaf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectpu.train.optimizers import stochastic_round_bf16 as jax_sr
from rectpu_torch.ops.fused_adam import fused_adam_plain, index_base, stochastic_round_bf16
from rectpu_torch.parallel.plan import ParallelPlan
from rectpu_torch.train.dispatch import StepScalars
from rectpu_torch.utils.hash32 import GlobalIndex, flat_index, global_index
from torch_mp_worker import build_model
from torch_mp_worker import fake_mesh as _fake_mesh

SEEDS = [0, 7, 2**30 + 5, 2**32 - 1]


def _global(shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * np.exp(rng.normal(size=shape) * 3)).astype(np.float32)


# (name, global shape, the shard's slice, its GlobalIndex)
CUTS = [
    ("rows", (48, 13), np.s_[16:32], GlobalIndex(16, 0, 13)),
    ("columns", (24, 40), np.s_[:, 20:40], GlobalIndex(0, 20, 40)),
    ("bias", (40,), np.s_[10:20], GlobalIndex(10, 0, 1)),
]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,shape,cut,index", CUTS, ids=[c[0] for c in CUTS])
def test_sr_of_a_shard_is_the_slice_of_rectpus_global_sr(name, shape, cut, index, seed):
    x = _global(shape, seed % 1000)
    want = np.asarray(jax_sr(jnp.asarray(x), jnp.asarray(seed, jnp.uint32)).view(jnp.int16))
    shard = torch.from_numpy(np.ascontiguousarray(x[cut]))
    for s in (seed, torch.tensor(seed, dtype=torch.int64)):
        got = stochastic_round_bf16(shard, s, index)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want[cut])
    assert torch.equal(global_index(shard.shape, "cpu", None), flat_index(shard.shape, "cpu"))


def test_global_index_wraps_at_2_32():
    idx = global_index((2, 3), "cpu", GlobalIndex(2**31, 1, 2))
    assert idx.tolist() == [[1, 2, 3], [3, 4, 5]]  # (2**31 + r) * 2 + 1 + c, mod 2**32


@pytest.mark.parametrize("cut", ["rows", "columns"])
def test_fused_adam_plain_on_a_shard_is_the_slice_of_the_global_sweep(cut):
    rng = np.random.default_rng(3)
    v_rows, w, lo, hi = 64, 9, 24, 48

    def make(scale=1.0, positive=False, dtype=torch.float32):
        a = rng.standard_normal((v_rows, w)).astype(np.float32) * scale
        return torch.from_numpy(np.abs(a) if positive else a).to(dtype)

    p, m = make(dtype=torch.bfloat16), make(0.1, dtype=torch.bfloat16)
    v, g = make(0.01, True, torch.bfloat16), make()
    opts = dict(lr=1e-3, m_sr=True, v_sr=True)
    part, index = ((np.s_[lo:hi], GlobalIndex(lo, 0, w)) if cut == "rows" else
                   (np.s_[:, 3:6], GlobalIndex(0, 3, w)))
    for t in (1, 2, 2**31 - 1):
        whole = fused_adam_plain(p, m, v, g, t, **opts)
        shard = fused_adam_plain(*(x[part].contiguous() for x in (p, m, v, g)), t, index=index,
                                 **opts)
        for a, b in zip(shard, whole):
            assert torch.equal(a.view(torch.int16), b[part].view(torch.int16)), t
    if cut == "rows":
        assert index_base((hi - lo, w), index) == lo * w
        assert index_base((8, w), GlobalIndex(2**29, 0, w)) == (2**29 * w) & 0xFFFFFFFF
        assert index_base((8, w), None) == 0
    else:
        with pytest.raises(ValueError, match="row shard"):
            index_base((v_rows, 3), index)


def _index_tree(tree):
    """Each leaf's global flat index, in the leaf's shape (int64)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index_tree(v) for v in tree)
    return flat_index(tree.shape, "cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("tp_mlp", [False, True], ids=["ep", "ep_tp"])
@pytest.mark.parametrize("family", ["deep_fm", "dlrm"])
def test_plan_places_every_leaf_as_shard_params_cuts_it(family, tp_mlp, mesh):
    """The index ``sr_index`` gives each leaf of the rank's view is that
    leaf's block of the global index array, cut by ``shard_params``."""
    d, m = mesh
    numeric = ("age", "action") if family == "dlrm" else ()
    model_kw = {"bot_hidden_units": (6, 8)} if family == "dlrm" else {}
    model, params = build_model(family, {}, model_kw, numeric)
    sharded = 0
    for rank in range(d * m):
        plan = ParallelPlan.create(d, m, table_rows=model.cfg.padded_buckets, tp_mlp=tp_mlp,
                                   mesh=_fake_mesh(d, m, rank))
        cut = plan.shard_params(_index_tree(params))
        for key, local in _leaves(cut):
            index = plan.sr_index(key, local)
            sharded += index is not None
            assert torch.equal(global_index(local.shape, "cpu", index), local), (rank, key, index)
    assert sharded >= d * m * (4 if tp_mlp else 1)


def test_scalars_name_a_subtree_leaf_by_its_full_path():
    seen = []
    scalars = StepScalars(None, 3)
    assert scalars.sr_index("table", torch.zeros(2, 2)) is None
    scalars.placement = lambda key, leaf: seen.append(key) or GlobalIndex(1, 0, 2)
    sub = scalars.within("mlp")
    assert sub.t == 3 and sub.sr_index("0/kernel", None) == GlobalIndex(1, 0, 2)
    assert sub.within("x").sr_index("", None) is not None
    assert scalars.sr_index("table", None) is not None
    assert seen == ["mlp/0/kernel", "mlp/x", "table"]
