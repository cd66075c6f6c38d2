"""The port's autotuner (``rectpu_torch.ops.autotune``) on the CPU.

On the card it chooses among the port's own kernels and launch geometries;
on the CPU the same candidates time the plain versions. These tests run it
at small shapes and check what it returns and pins, not which candidate
wins (host times are noise at these sizes). A fixture puts every pin back,
as rectpu's ``tests/test_autotune.py`` does, since pins are module globals.
"""

import numpy as np
import pytest
import torch

from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.ops import autotune as at
from rectpu_torch.ops import fm as t_fm
from rectpu_torch.ops import interaction as t_int
from rectpu_torch.ops import scatter_rows as t_sc

PINS = (t_fm._FLAT_AUTO, t_int._INTERACT_AUTO, t_sc._AUTO_CHUNK)


@pytest.fixture(autouse=True)
def restore_pins():
    saved = [dict(p) for p in PINS]
    yield saved
    for pin, copy in zip(PINS, saved):
        pin.clear()
        pin.update(copy)


def _field_info(fs):
    return tuple(int(o) for o in fs.offsets), tuple(fs.field_sizes)


def test_autotune_returns_rectpus_keys_and_pins_its_picks(restore_pins):
    fs = ml_100k_feature_set()
    k = 8
    picks = at.autotune(batch=64, num_fields=fs.num_fields, embedding_size=k,
                        vocab_rows=6144, field_info=_field_info(fs), device="cpu")
    assert set(picks) == {"lookup", "fm", "flat_scatter", "scatter_chunk", "fm_flat",
                          "interact", "timings_s"}
    # the one-kernel choices name the route that ran; the rest lie in the
    # allowed sets
    assert picks["lookup"] == picks["fm"] == picks["flat_scatter"] == "plain"
    assert picks["scatter_chunk"] in at.SCATTER_CHUNKS
    assert picks["fm_flat"] in ("xla", "pallas")
    assert picks["interact"] in ("pallas", "pallas-mxu")
    # every pin of the CPU equals its pick; the card's pins are untouched
    assert t_fm._FLAT_AUTO["cpu"] == picks["fm_flat"]
    assert t_int._INTERACT_AUTO["cpu"] == picks["interact"]
    assert t_sc._AUTO_CHUNK["chunk"] == picks["scatter_chunk"]
    for pin, saved in zip(PINS[:2], restore_pins[:2]):
        assert pin["cuda"] == saved["cuda"]
    timings = picks["timings_s"]
    assert set(timings) == {"lookup/plain", "fm/plain", "scatter_chunk/16", "scatter_chunk/32",
                            "scatter_chunk/64", "fm_flat/xla", "fm_flat/pallas",
                            "interact_flat/pallas", "interact_flat/pallas-mxu"}
    assert all(isinstance(t, float) and t > 0 for t in timings.values())
    assert picks["scatter_chunk"] == min(at.SCATTER_CHUNKS,
                                         key=lambda c: timings[f"scatter_chunk/{c}"])
    assert picks["fm_flat"] == min(("xla", "pallas"), key=lambda n: timings[f"fm_flat/{n}"])


@pytest.mark.parametrize("field_info,flat", [(None, True), ("ml100k", False)])
def test_autotune_without_the_flat_path(field_info, flat, restore_pins):
    """Without field_info or with flat=False only the lookup and the 3-D FM
    are timed, as in rectpu, and no flat pin moves."""
    fs = ml_100k_feature_set()
    info = _field_info(fs) if field_info else None
    picks = at.autotune(batch=16, num_fields=fs.num_fields, embedding_size=4,
                        vocab_rows=fs.total_buckets, include_grad=False, field_info=info,
                        flat=flat, device="cpu")
    assert set(picks) == {"lookup", "fm", "timings_s"}
    assert set(picks["timings_s"]) == {"lookup/plain", "fm/plain"}
    assert [dict(p) for p in PINS] == restore_pins


def test_pins_reach_the_dispatchers():
    """What the autotuner pins is what "auto" runs: the interaction's
    product rounding, the flat FM's route."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(5, 4 * 32)).astype(np.float32)).to(torch.bfloat16)
    exact = t_int.interact_plain(x, 4, 32, round_products=False)
    rounded = t_int.interact_plain(x, 4, 32, round_products=True)
    assert not torch.equal(exact, rounded)
    assert torch.equal(t_int.interact_flat(x, 4, 32), rounded)  # the default pin
    t_int.set_interact_auto_impl("xla", "cpu")
    assert torch.equal(t_int.interact_flat(x, 4, 32), exact)
    t_fm.set_flat_auto_impl("pallas", "cpu")
    assert torch.equal(t_fm.fm_cross_flat_dispatch(x, 4, 32),
                       t_fm.fm_cross_flat_pallas(x, 4, 32))


def test_pin_setters_check_their_values():
    with pytest.raises(ValueError):
        t_fm.set_flat_auto_impl("auto", "cpu")
    with pytest.raises(ValueError):
        t_int.set_interact_auto_impl("mxu", "cpu")
    with pytest.raises(ValueError, match="chunk"):
        t_sc.set_auto_chunk(0)
    t_int.set_interact_auto_impl("pallas", "cuda")
    t_sc.set_auto_chunk(16)
    assert t_int._INTERACT_AUTO["cuda"] == "pallas" and t_sc._AUTO_CHUNK["chunk"] == 16


def test_scatter_chunk_is_geometry_only_on_the_cpu():
    """scatter_rows_dense takes the pinned chunk on the card; on the CPU the
    plain version computes the same sums whatever the chunk."""
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(-2, 50, 300).astype(np.int32))
    upd = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32))
    want = t_sc.scatter_rows_plain(ids, upd, 48)
    for chunk in at.SCATTER_CHUNKS:
        assert torch.equal(t_sc.scatter_rows_dense(ids, upd, 48, chunk=chunk), want)
    with pytest.raises(ValueError, match="CUDA"):
        t_sc.scatter_rows_cuda(ids, upd, 48, chunk=16)


@pytest.mark.parametrize("k", [8, 64])
def test_autotune_times_the_flat_kernels_only_where_rectpu_would(k, monkeypatch):
    """The flat FM routes are timed through the dispatcher, so the "pallas"
    candidate runs the flat kernels' route at F*K % 128 == 0 (k=64, F=26:
    1664) and rectpu's "xla" fallback otherwise (k=8: 208)."""
    calls = []
    flat_pallas = t_fm.fm_cross_flat_pallas
    monkeypatch.setattr(t_fm, "fm_cross_flat_pallas",
                        lambda *a: calls.append(1) or flat_pallas(*a))
    fs = ml_100k_feature_set()
    at.autotune(batch=8, num_fields=fs.num_fields, embedding_size=k, vocab_rows=fs.total_buckets,
                include_grad=False, field_info=_field_info(fs), device="cpu")
    assert bool(calls) == (fs.num_fields * k % 128 == 0)


def test_auto_routes_follow_the_autotuners_pins():
    """After the autotuner, "auto" computes what the picked candidate does."""
    fs = ml_100k_feature_set()
    k = 64
    picks = at.autotune(batch=8, num_fields=fs.num_fields, embedding_size=k,
                        vocab_rows=fs.total_buckets, include_grad=False,
                        field_info=_field_info(fs), device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(5, fs.num_fields * k)).astype(np.float32)).to(
        torch.bfloat16)
    assert torch.equal(t_int.interact_flat(x, fs.num_fields, k),
                       t_int.interact_flat(x, fs.num_fields, k, impl=picks["interact"]))
    assert torch.equal(t_fm.fm_cross_flat_dispatch(x, fs.num_fields, k),
                       t_fm.fm_cross_flat_dispatch(x, fs.num_fields, k, impl=picks["fm_flat"]))
