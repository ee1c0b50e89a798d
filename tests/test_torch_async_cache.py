"""The port's async corpus cache (`AsyncPackCache` and its cached
packer), its legacy loop packer and the nested planner against the JAX
package's, on the CPU (data/async_schedule.py).

Every comparison is bit for bit, dtype included: the cached packer and
the loop packer of each package against the other package's, and against
the port's flat packer, in eval mode and over two training epochs from
one shared RandomState; the nested planner's capacities and segment plan
against the flat planner's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ggnn_tpu.data import async_schedule as jax_async
from ggnn_tpu_torch.data import async_schedule
from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.data.synthetic import (async_fixture_molecules,
                                           synthetic_molecules)
from ggnn_tpu_torch.training.config import default_params_for
from ggnn_tpu_torch.training.variants import make_adapter

torch.set_num_threads(1)

T, R, S, H = 4, 4, 40, 16
# Graphs the schedule treats apart: an isolated node, an edgeless graph,
# a self-loop.
ODD_GRAPHS = [
    {"targets": [[0.5]], "graph": [[0, 1, 1]],
     "node_features": [[1, 0, 0, 0, 0], [0, 1, 0, 0, 0], [0, 0, 1, 0, 0]]},
    {"targets": [[-0.2]], "graph": [],
     "node_features": [[1, 0, 0, 0, 0], [0, 0, 0, 1, 0]]},
    {"targets": [[None]], "graph": [[0, 2, 1], [1, 1, 2], [2, 3, 2]],
     "node_features": [[0, 1, 0, 0, 0], [0, 0, 1, 0, 0], [1, 0, 0, 0, 0]]},
]
# name -> (corpus, node budget)
CORPORA = {
    "molecules": (lambda: synthetic_molecules(160, seed=11), 500),
    "fixture": (lambda: async_fixture_molecules(60, seed=2), 100),
    "odd": (lambda: synthetic_molecules(40, seed=3) + ODD_GRAPHS * 3, 200),
}


def _assert_identical(got, want, name="batch"):
    """Leaf for leaf, dtypes included, through segments and tuples."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, name
        for field in dataclasses.fields(want):
            _assert_identical(getattr(got, field.name),
                              getattr(want, field.name),
                              f"{name}.{field.name}")
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), name
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_identical(a, b, f"{name}[{i}]")
    elif want is None:
        assert got is None, name
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_streams(got, want, label):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0, label
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_identical(a, b, f"{label} batch {i}")


def _both(name):
    """(port processed, JAX processed, budget, port caps, JAX caps)."""
    make, budget = CORPORA[name]
    raw = make()
    proc = async_schedule.preprocess_async(raw, T, True, R, S, [0], {},
                                           False)
    ref = jax_async.preprocess_async(raw, T, True, R, S, [0], {}, False)
    caps = async_schedule.plan_async_capacities_multi([proc], T, budget, R)
    jax_caps = jax_async.plan_async_capacities_multi([ref], T, budget, R)
    assert dataclasses.asdict(caps) == dataclasses.asdict(jax_caps)
    return proc, ref, budget, caps, jax_caps


def _stripped(mod, processed):
    """The corpus with its flat tables dropped and the nested schedules
    kept (rebuilt from the flat tables first)."""
    return [dict(g, prop_schedules=mod.get_prop_schedules(dict(g)),
                 flat_schedules=None) for g in processed]


def _epochs(mod, proc, budget, caps, training, **kwargs):
    """Two epochs' batches (one in eval mode) from one RandomState."""
    rng = np.random.RandomState(3) if training else None
    out = []
    for _ in range(2 if training else 1):
        out += list(mod.pack_async_batches(proc, T, budget, caps, R, S, H, 5,
                                           training, rng, **kwargs))
    return out


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_cached_packer_identical_to_jax_and_flat(corpus, training):
    proc, ref, budget, caps, jax_caps = _both(corpus)
    cache = async_schedule.build_async_pack_cache(proc, R, S, T)
    jax_cache = jax_async.build_async_pack_cache(ref, R, S, T)
    assert cache.matches(proc, R, S, T) and jax_cache.matches(ref, R, S, T)
    got = _epochs(async_schedule, proc, budget, caps, training, cache=cache)
    _assert_streams(got, _epochs(jax_async, ref, budget, jax_caps, training,
                                 cache=jax_cache), "jax cached")
    _assert_streams(got, _epochs(async_schedule, proc, budget, caps,
                                 training), "port flat")


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_loop_packer_and_nested_planner_identical_to_jax(corpus, training):
    """A corpus with its flat tables stripped plans through the nested
    planner (the flat planner's capacities and plan) and packs through
    the loop packer instead of raising, in both packages alike."""
    proc, ref, budget, caps, _ = _both(corpus)
    stripped = _stripped(async_schedule, proc)
    jax_stripped = _stripped(jax_async, ref)
    nested = async_schedule.plan_async_capacities_multi([stripped], T,
                                                        budget, R)
    assert nested == caps
    jax_nested = jax_async.plan_async_capacities_multi([jax_stripped], T,
                                                       budget, R)
    assert dataclasses.asdict(jax_nested) == dataclasses.asdict(caps)
    jax_caps = jax_async.AsyncCapacities(**dataclasses.asdict(caps))
    got = _epochs(async_schedule, stripped, budget, caps, training)
    _assert_streams(got, _epochs(jax_async, jax_stripped, budget, jax_caps,
                                 training), "jax loop")
    _assert_streams(got, _epochs(async_schedule, proc, budget, caps,
                                 training), "port flat")
    # use_flat=False takes the loop over a corpus with flat tables too.
    _assert_streams(got, _epochs(async_schedule, proc, budget, caps,
                                 training, use_flat=False), "use_flat")


def test_heterogeneous_corpus_takes_the_loop_packer():
    """One graph without its flat table sends the whole corpus through
    the loop packer and the nested planner, as in JAX."""
    proc, ref, budget, caps, jax_caps = _both("molecules")
    broken = [dict(g) for g in proc]
    async_schedule.get_prop_schedules(broken[7])
    broken[7]["flat_schedules"] = None
    jax_broken = [dict(g) for g in ref]
    jax_async.get_prop_schedules(jax_broken[7])
    jax_broken[7]["flat_schedules"] = None
    assert async_schedule.build_async_pack_cache(broken, R, S, T) is None
    assert async_schedule.plan_async_capacities_multi(
        [broken], T, budget, R) == caps
    got = list(async_schedule.pack_async_batches(broken, T, budget, caps, R,
                                                 S, H, 5, False))
    _assert_streams(got, jax_async.pack_async_batches(
        jax_broken, T, budget, jax_caps, R, S, H, 5, False), "jax")
    _assert_streams(got, async_schedule.pack_async_batches(
        proc, T, budget, caps, R, S, H, 5, False), "flat")


def test_nested_schedules_from_flat_invert_the_flattening():
    raw = synthetic_molecules(24, seed=13) + ODD_GRAPHS
    for g in raw:
        sched = async_schedule.graph_to_propagation_schedules(
            g["graph"], T, True, R, S, num_nodes=len(g["node_features"]))
        flat = async_schedule._flatten_schedules(sched, S, T)
        back = async_schedule.nested_schedules_from_flat(flat)
        want = jax_async.nested_schedules_from_flat(
            jax_async._flatten_schedules(sched, S, T))
        assert len(back) == len(sched) == len(want)
        for (gi, gs, gm, gr), (si, ss, sm, sr), (wi, ws, wm, wr) in zip(
                back, sched, want):
            np.testing.assert_array_equal(gi, si)
            np.testing.assert_array_equal(gi, wi)
            for got, src, ref in ((gs, ss, ws), (gm, sm, wm)):
                assert [[list(x) for x in step] for step in got] == \
                    [[list(x) for x in step] for step in src] == \
                    [[list(x) for x in step] for step in ref]
            assert [list(x) for x in gr] == [list(x) for x in sr] == \
                [list(x) for x in wr]


def _relabeled(processed):
    return [dict(g, labels=[v + 1.0 if v is not None else None
                            for v in g["labels"]]) for g in processed]


def _refeatured(processed):
    return [dict(g, init=np.asarray(g["init"]) * 2.0) for g in processed]


def _re_edged(mod, _processed):
    other = synthetic_molecules(160, seed=11)
    for g in other:
        g["graph"] = g["graph"][:-1]
    return mod.preprocess_async(other, T, True, R, S, [0], {}, False)


STALE = {
    "labels": lambda mod, p: _relabeled(p),
    "features": lambda mod, p: _refeatured(p),
    "edges": _re_edged,
    "length": lambda mod, p: p[:-1],
}


@pytest.mark.parametrize("change", sorted(STALE))
def test_stale_cache_does_not_match_and_is_rebuilt(change):
    """A cache of another corpus does not match (in either package); the
    packer then packs the corpus it was given, and the adapter builds the
    new corpus its own cache."""
    proc, ref, budget, caps, _ = _both("molecules")
    cache = async_schedule.build_async_pack_cache(proc, R, S, T)
    jax_cache = jax_async.build_async_pack_cache(ref, R, S, T)
    other = STALE[change](async_schedule, proc)
    jax_other = STALE[change](jax_async, ref)
    assert not cache.matches(other, R, S, T)
    assert not jax_cache.matches(jax_other, R, S, T)
    _assert_streams(
        async_schedule.pack_async_batches(other, T, budget, caps, R, S, H, 5,
                                          False, cache=cache),
        async_schedule.pack_async_batches(other, T, budget, caps, R, S, H, 5,
                                          False), "stale cache")

    config = {**default_params_for("async"), "hidden_size": H,
              "propagation_rounds": R, "propagation_substeps": S,
              "num_nodes": budget}
    adapter = make_adapter("async", config, DatasetMeta(30, T, 5))
    adapter.caps = caps
    first = list(adapter.batches(proc, False))
    assert adapter._pack_caches[id(proc)][1].matches(proc, R, S, T)
    second = list(adapter.batches(other, False))
    rebuilt = adapter._pack_caches[id(other)][1]
    assert rebuilt is not adapter._pack_caches[id(proc)][1]
    assert rebuilt.matches(other, R, S, T)
    _assert_streams(first, async_schedule.pack_async_batches(
        proc, T, budget, caps, R, S, H, 5, False), "adapter first")
    _assert_streams(second, async_schedule.pack_async_batches(
        other, T, budget, caps, R, S, H, 5, False), "adapter rebuilt")


@pytest.mark.parametrize("mode", ["graphs", "batches"])
@pytest.mark.parametrize("use_cache", [True, False])
def test_adapter_honours_async_pack_cache(use_cache, mode):
    proc, _, budget, caps, _ = _both("fixture")
    config = {**default_params_for("async"), "hidden_size": H,
              "propagation_rounds": R, "propagation_substeps": S,
              "num_nodes": budget, "async_pack_cache": use_cache,
              "async_epoch_shuffle": mode}
    adapter = make_adapter("async", config, DatasetMeta(30, T, 5))
    adapter.caps = caps
    got = list(adapter.batches(proc, False))
    assert (id(proc) in adapter._pack_caches) is use_cache
    _assert_streams(got, async_schedule.pack_async_batches(
        proc, T, budget, caps, R, S, H, 5, False), "adapter")
    if mode == "graphs":
        rng = np.random.RandomState(5)
        _assert_streams(adapter.batches(proc, True, rng),
                        async_schedule.pack_async_batches(
                            proc, T, budget, caps, R, S, H, 5, True,
                            np.random.RandomState(5)), "training")


def test_adapter_cache_is_first_in_first_out():
    proc, _, budget, caps, _ = _both("fixture")
    config = {**default_params_for("async"), "hidden_size": H,
              "propagation_rounds": R, "propagation_substeps": S,
              "num_nodes": budget}
    adapter = make_adapter("async", config, DatasetMeta(30, T, 5))
    adapter.caps = caps
    corpora = [list(proc) for _ in range(6)]
    for corpus in corpora:
        adapter.batches(corpus, False)
    assert len(adapter._pack_caches) == adapter._CACHE_CAP
    assert list(adapter._pack_caches) == [id(c) for c in corpora[-4:]]


def test_empty_corpus_and_oversize_graph():
    caps = async_schedule.AsyncCapacities(
        nodes=64, graphs=8, initial_nodes=64, sending_edges=64,
        receiving_nodes=64)
    assert async_schedule.build_async_pack_cache([], R, S, T) is None
    assert list(async_schedule.pack_async_batches([], T, 100, caps, R, S, H,
                                                  3, False)) == []
    assert async_schedule.plan_async_capacities_multi(
        [[]], T, 100, R) == async_schedule.AsyncCapacities(
        **dataclasses.asdict(jax_async.plan_async_capacities_multi(
            [[]], T, 100, R)))
    proc, ref, _, _, _ = _both("molecules")
    big = max(proc, key=lambda g: len(g["init"]))
    small = async_schedule.AsyncCapacities(
        nodes=64, graphs=8, initial_nodes=1, sending_edges=1,
        receiving_nodes=1)
    cache = async_schedule.build_async_pack_cache([big], R, S, T)
    for kwargs in ({"cache": cache}, {}, {"use_flat": False}):
        with pytest.raises(ValueError, match="exceeds async capacities"):
            list(async_schedule.pack_async_batches(
                [big], T, 500, small, R, S, H, 5, False, **kwargs))
