"""The port's native packer (ggnn_tpu_torch/native, data/native_pack.py
and the native paths of the adapters and the Predictor) against the JAX
package's native packer and against the port's numpy packers, on the
CPU: the port's library is built here with g++ into build/native/.

Every comparison is bit for bit, dtype included:
  * port native against JAX native, in eval mode and in training mode
    from the same RandomState (task_sample_ratios included);
  * port native against port numpy in eval mode, and in training mode
    without task_sample_ratios (the two pipelines blank the sampled
    labels over different orders, as JAX's do);
  * the bf16 adjacency's bits against JAX's ml_dtypes array.
"""

import dataclasses
import subprocess
import sys
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from ggnn_tpu.data import native_pack as jax_native_pack
from ggnn_tpu.data.loader import DatasetMeta as JaxDatasetMeta
from ggnn_tpu.data.synthetic import synthetic_giant_graph
from ggnn_tpu.models.base import init_output_heads as jax_init_heads
from ggnn_tpu.models.sparse_ggnn import SparseGGNN as JaxSparseGGNN
from ggnn_tpu.native import native_available as jax_native_available
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu.training.config import default_params_for as jax_defaults
from ggnn_tpu_torch import native
from ggnn_tpu_torch.data import native_pack, packing
from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training import variants
from ggnn_tpu_torch.training.config import default_params_for

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _native_library():
    """The libraries build on first use, here, not when the module is
    imported."""
    if not (native.native_available() and jax_native_available()):
        pytest.skip("g++ could not build a native packer")


H = 16
RATIOS = {"0": 0.5}


def _bits(leaf):
    """(dtype name, array) of a leaf; a bf16 leaf (a torch tensor in the
    port, an ml_dtypes array in JAX) as its raw 16-bit patterns."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16", leaf.view(torch.int16).numpy().view(np.uint16)
        return str(leaf.dtype).replace("torch.", ""), leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype == np.dtype(ml_dtypes.bfloat16):
        return "bfloat16", arr.view(np.uint16)
    return str(arr.dtype), arr


def _assert_identical(got, want, label=""):
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)], label
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, (label, name)
            continue
        (da, a), (db, b) = _bits(a), _bits(b)
        assert da == db, (label, name, da, db)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {name}")


def _assert_streams(got, want, label=""):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0, label
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_identical(a, b, f"{label} batch {i}")


def _rng(training, seed):
    return np.random.RandomState(seed) if training else None


# ------------------------------------------------------------- library

def test_library_builds_into_build_native():
    lib = native.get_lib()
    assert lib is native.require_lib()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert path.exists() and path.name.startswith("libpacker_")
    assert path.name.endswith(f"_{native._host_salt()}.so")
    for entry in ("pack_dense_batch", "pack_gcn_dense_batch",
                  "pack_sparse_batch", "pack_single_sparse",
                  "pack_gcn_batch"):
        assert hasattr(lib, entry)


@pytest.mark.parametrize("value,disabled", [
    ("1", True), ("true", True), ("YES", True), (" on ", True),
    ("0", False), ("false", False), ("", False)])
def test_no_native_env_is_parsed_as_jax_parses_it(monkeypatch, value,
                                                  disabled):
    from ggnn_tpu import native as jax_native
    monkeypatch.setenv("GGNN_TPU_NO_NATIVE", value)
    assert native._no_native_env() is disabled
    assert jax_native._no_native_env() is disabled
    assert native.native_available() is not disabled
    if disabled:
        with pytest.raises(RuntimeError, match="GGNN_TPU_NO_NATIVE"):
            native.require_lib()


def test_concurrent_builders_share_one_library(tmp_path, monkeypatch):
    """Four threads and two processes build into an empty directory at
    once: one g++ run, one library, every caller handed its path."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    code = ("import sys; from pathlib import Path; "
            "import ggnn_tpu_torch.native as n; "
            "n.BUILD_DIR = Path(sys.argv[1]); print(n.build())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(native.build()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    want = native.library_path()
    assert set(map(str, paths)) | set(outs) == {str(want)}
    assert sorted(f.name for f in tmp_path.iterdir()
                  if f.name != ".lock") == [want.name]


def test_failed_build_warns_and_falls_back(tmp_path, monkeypatch):
    bad = tmp_path / "packer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LOAD_ERROR", None)
    with pytest.warns(RuntimeWarning, match="g\\+\\+ failed"):
        assert native.get_lib() is None
    assert not variants._use_native({})
    with pytest.raises(RuntimeError, match="build/load failed"):
        native.require_lib()


# ------------------------------------------------------------- packers

def _sparse_streams(tie, training, ratios, pkg, budget=400):
    raw = synthetic_molecules(160, seed=4)
    t_dim = 4 if tie else 8
    proc = pkg.preprocess_sparse_native(raw, t_dim, tie, [0], ratios,
                                        training, _rng(training, 0))
    caps = pkg.plan_capacities_native(proc, budget)
    return caps, pkg.pack_sparse_batches_native(
        proc, t_dim, tie, budget, caps, H, 5, training, _rng(training, 1))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("tie", [True, False])
def test_sparse_native_identical_to_jax_and_numpy(tie, training):
    caps, got = _sparse_streams(tie, training, RATIOS, native_pack)
    jax_caps, want = _sparse_streams(tie, training, RATIOS, jax_native_pack)
    assert dataclasses.asdict(caps) == dataclasses.asdict(jax_caps)
    got = list(got)
    _assert_streams(got, want, "jax")
    raw = synthetic_molecules(160, seed=4)
    t_dim = 4 if tie else 8
    ratios = {} if training else RATIOS
    proc = packing.preprocess_sparse(raw, t_dim, tie, [0], ratios, training,
                                     _rng(training, 0))
    assert packing.plan_capacities(proc, t_dim, 400) == caps
    if training:
        got = list(_sparse_streams(tie, training, ratios, native_pack)[1])
    _assert_streams(got, packing.pack_sparse_batches(
        proc, t_dim, 400, caps, H, 5, training, _rng(training, 1)), "numpy")


@pytest.mark.parametrize("bucket_sizes", [None, [16, 32]])
@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("tie", [True, False])
def test_dense_native_identical_to_jax_and_numpy(tie, training,
                                                 bucket_sizes):
    raw = synthetic_molecules(120, seed=2)
    t_dim = 4 if tie else 8
    sizes = None if bucket_sizes is None else np.asarray(bucket_sizes)

    def stream(pkg, ratios):
        proc = pkg.preprocess_dense_native(
            raw, [0], ratios, training, _rng(training, 0),
            bucket_sizes=sizes, num_edge_types=t_dim, tie_fwd_bkwd=tie)
        return pkg.pack_dense_batches_native(
            proc, 8, H, 5, t_dim, tie, training, _rng(training, 1),
            drop_remainder=False)

    _assert_streams(stream(native_pack, RATIOS),
                    stream(jax_native_pack, RATIOS), "jax")
    ratios = {} if training else RATIOS
    bucketed, got_sizes = packing.preprocess_dense(
        raw, t_dim, tie, [0], ratios, training, _rng(training, 0),
        bucket_sizes=sizes)
    _assert_streams(stream(native_pack, ratios), packing.pack_dense_batches(
        bucketed, got_sizes, 8, H, 5, training, _rng(training, 1),
        drop_remainder=False), "numpy")


@pytest.mark.parametrize("training", [False, True])
def test_gcn_dense_native_identical_to_jax_and_numpy(training):
    raw = synthetic_molecules(120, seed=2)
    sizes = np.array([16, 32])

    def stream(pkg, ratios):
        proc = pkg.preprocess_gcn_dense_native(
            raw, [0], ratios, training, _rng(training, 0), bucket_sizes=sizes)
        return pkg.pack_gcn_dense_batches_native(
            proc, 8, H, 5, training, _rng(training, 1))

    _assert_streams(stream(native_pack, RATIOS),
                    stream(jax_native_pack, RATIOS), "jax")
    ratios = {} if training else RATIOS
    bucketed, got_sizes = packing.preprocess_gcn_dense(
        raw, [0], ratios, training, _rng(training, 0), bucket_sizes=sizes)
    _assert_streams(stream(native_pack, ratios), packing.pack_dense_batches(
        bucketed, got_sizes, 8, H, 5, training, _rng(training, 1),
        drop_remainder=False), "numpy")


GCN_CASES = {
    "mols": (lambda: synthetic_molecules(200, seed=3), 500),
    "giant": (lambda: synthetic_giant_graph(1200, seed=1), 2500),
    "selfloop": (lambda: [{"targets": [[0.5]],
                           "node_features": [[1, 0, 0, 0, 0]] * 3,
                           "graph": [[0, 1, 1], [1, 1, 2], [1, 2, 2],
                                     [0, 1, 1]]}], 500),
}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("case", sorted(GCN_CASES))
def test_gcn_edge_list_native_identical_to_jax_and_numpy(case, training):
    make, budget = GCN_CASES[case]
    raw = make()

    def stream(pkg, ratios):
        proc = pkg.preprocess_gcn_native(raw, [0], ratios, training,
                                         _rng(training, 0))
        caps = pkg.plan_gcn_capacities_native(proc, budget)
        return caps, pkg.pack_gcn_batches_native(
            proc, budget, caps, H, 5, training, _rng(training, 1))

    caps, got = stream(native_pack, RATIOS)
    jax_caps, want = stream(jax_native_pack, RATIOS)
    assert dataclasses.asdict(caps) == dataclasses.asdict(jax_caps)
    _assert_streams(got, want, "jax")
    ratios = {} if training else RATIOS
    proc = packing.preprocess_gcn(raw, [0], ratios, training,
                                  _rng(training, 0))
    caps, got = stream(native_pack, ratios)
    assert packing.plan_gcn_capacities(proc, budget) == caps
    _assert_streams(got, packing.pack_gcn_batches(
        proc, budget, caps, H, 5, training, _rng(training, 1)), "numpy")


@pytest.mark.parametrize("tie", [True, False])
def test_bf16_adjacency_bits_equal_jax(tie):
    """The bf16 adjacency (a host torch tensor: numpy has no bf16) holds
    the bits of JAX's ml_dtypes array and of the f32 one cast."""
    raw = synthetic_molecules(100, seed=9)
    t_dim = 4 if tie else 8

    def stream(pkg, dtype):
        proc = pkg.preprocess_dense_native(raw, [0], {}, False,
                                           num_edge_types=t_dim,
                                           tie_fwd_bkwd=tie)
        return list(pkg.pack_dense_batches_native(
            proc, 8, H, 5, t_dim, tie, False, drop_remainder=False,
            adjacency_dtype=dtype))

    got = stream(native_pack, torch.bfloat16)
    assert all(b.adjacency.dtype == torch.bfloat16 for b in got)
    _assert_streams(got, stream(jax_native_pack,
                                np.dtype(ml_dtypes.bfloat16)), "jax")
    for b, f in zip(got, stream(native_pack, np.float32)):
        assert torch.equal(b.adjacency,
                           torch.from_numpy(f.adjacency).to(torch.bfloat16))
    with pytest.raises(ValueError, match="adjacency_dtype"):
        stream(native_pack, np.float16)


def test_ell_block_is_not_ported():
    """`ell_block` through the native packer: ELLGraphBatches equal to
    the JAX native packer's, leaf for leaf (tests/test_torch_ell_packing.py
    holds the layout in depth). The name is the one this test had while
    the option raised NotImplementedError, kept so its history reads as
    one test; it now checks that the option is ported."""
    raw = synthetic_molecules(10, seed=1)

    def stream(pkg):
        proc = pkg.preprocess_sparse_native(raw, 4, True, [0], {}, False)
        caps = pkg.plan_capacities_native(proc, 300)
        return list(pkg.pack_sparse_batches_native(
            proc, 4, True, 300, caps, H, 5, False, None, ell_block=8,
            ell_k=64))

    got = stream(native_pack)
    assert got and all(type(b).__name__ == "ELLGraphBatch" for b in got)
    _assert_streams(got, stream(jax_native_pack), "jax")


# ------------------------------------------------------- error cases

def _corrupt_ids(pkg):
    pkg.FlatCorpus.from_raw([{"targets": [[0.1]], "graph": [[0, 1, 7]],
                              "node_features": [[1, 0], [0, 1]]}], [0])


def _bad_type(pkg):
    pkg.preprocess_sparse_native(
        [{"targets": [[0.1]], "graph": [[0, 5, 1]],
          "node_features": [[1, 0], [0, 1]]}], 4, True, [0], {}, False)


def _graph_too_big(pkg):
    pkg.preprocess_dense_native(
        [{"targets": [[0.1]], "graph": [[0, 1, 40]],
          "node_features": [[1, 0]] * 41}], [0], {}, False,
        bucket_sizes=np.array([8, 32]))


def _trailing_rows_too_big(pkg):
    pkg.preprocess_dense_native(
        [{"targets": [[0.5]], "graph": [[0, 1, 1]],
          "node_features": [[1, 0]] * 20}], [0], {}, False,
        bucket_sizes=np.array([4, 8]))


def _trailing_rows_fit(pkg):
    """Feature rows past the largest edge vertex land in a bucket that
    holds them all: the batches, returned for the comparison."""
    data = [{"targets": [[0.5]], "graph": [[0, 1, 1], [1, 2, 2]],
             "node_features": [[1, 0]] * 10},
            {"targets": [[0.2]], "graph": [[0, 1, 1]],
             "node_features": [[0, 1], [1, 0]]}]
    proc = pkg.preprocess_dense_native(data, [0], {}, False,
                                       bucket_sizes=np.array([4, 6, 12]))
    assert proc.bucket_v[0] == 12
    return list(pkg.pack_dense_batches_native(
        proc, 4, H, 2, 4, True, False, drop_remainder=False))


def _gcn_overflow(pkg):
    proc = pkg.preprocess_gcn_native(synthetic_molecules(40, seed=3), [0],
                                     {}, False)
    caps = pkg.plan_gcn_capacities_native(proc, 500)
    list(pkg.pack_gcn_batches_native(
        proc, 500, dataclasses.replace(caps, edges_per_type=8), H, 5, False,
        None))


def _sparse_overflow(pkg):
    proc = pkg.preprocess_sparse_native(synthetic_molecules(40, seed=3), 4,
                                        True, [0], {}, False)
    caps = pkg.plan_capacities_native(proc, 500)
    list(pkg.pack_sparse_batches_native(
        proc, 4, True, 500, dataclasses.replace(caps, edges_per_type=4), H,
        5, False, None))


def _budget_past_capacity(pkg):
    proc = pkg.preprocess_sparse_native(synthetic_molecules(20, seed=3), 4,
                                        True, [0], {}, False)
    caps = pkg.plan_capacities_native(proc, 200)
    list(pkg.pack_sparse_batches_native(proc, 4, True, 10 * caps.nodes,
                                        caps, H, 5, False, None))


def _width_mismatch(pkg):
    proc = pkg.preprocess_sparse_native(synthetic_molecules(4, seed=0), 4,
                                        True, [0], {}, False)
    caps = pkg.plan_capacities_native(proc, 100)
    list(pkg.pack_sparse_batches_native(proc, 4, True, 100, caps, H, 3,
                                        False, None))


def _hidden_below_width(pkg):
    proc = pkg.preprocess_sparse_native(synthetic_molecules(4, seed=0), 4,
                                        True, [0], {}, False)
    caps = pkg.plan_capacities_native(proc, 100)
    list(pkg.pack_sparse_batches_native(proc, 4, True, 100, caps, 4, 5,
                                        False, None))


def _empty_graph_rows(pkg):
    corpus = pkg.FlatCorpus.from_raw(
        [{"targets": [[0.5]], "graph": [], "node_features": []},
         {"targets": [[0.1]], "graph": [[0, 1, 1]],
          "node_features": [[1, 0], [0, 1]]}], [0])
    assert corpus.num_graphs == 2
    return corpus


ERROR_CASES = {
    "corrupt_ids": (_corrupt_ids, "vertex"),
    "bad_type": (_bad_type, "edge type 5"),
    "graph_too_big": (_graph_too_big, "bucket"),
    "trailing_rows_too_big": (_trailing_rows_too_big, "bucket"),
    "trailing_rows_fit": (_trailing_rows_fit, None),
    "gcn_overflow": (_gcn_overflow, "capacit"),
    "sparse_overflow": (_sparse_overflow, "capacit"),
    "budget_past_capacity": (_budget_past_capacity, "node_budget"),
    "width_mismatch": (_width_mismatch, "corpus feature width"),
    "hidden_below_width": (_hidden_below_width, "hidden_size"),
    "empty_graph_rows": (_empty_graph_rows, None),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_native_rejects_and_accepts_what_jax_does(case):
    fn, message = ERROR_CASES[case]
    if message is None:
        got, want = fn(native_pack), fn(jax_native_pack)
        if isinstance(got, list):
            _assert_streams(got, want, case)
        else:
            _assert_identical(got, want, case)
        return
    for pkg in (native_pack, jax_native_pack):
        with pytest.raises(ValueError, match=message):
            fn(pkg)


# ------------------------------------------------- one-graph serving

def _predictors(tie, max_nodes=64, max_graphs=16, native_pack_on=True):
    t_dim = 4 if tie else 8
    overrides = {"hidden_size": H, "tie_fwd_bkwd": tie,
                 "native_pack": native_pack_on}
    config = {**default_params_for("sparse"), **overrides}
    jax_config = {**jax_defaults("sparse"), **overrides}
    key = __import__("jax").random.PRNGKey(0)
    jax_state = {"params": {
        "graph": JaxSparseGGNN(jax_config, t_dim).init_params(key),
        "heads": jax_init_heads(key, H, [0])}}
    jax_pred = JaxPredictor("sparse", jax_config,
                            JaxDatasetMeta(max_nodes, t_dim, H), jax_state,
                            max_nodes=max_nodes, max_graphs=max_graphs)
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(SparseGGNN(config, t_dim, gen),
                         init_output_heads(gen, H, [0]))
    port = Predictor("sparse", config, DatasetMeta(max_nodes, t_dim, H),
                     params, max_nodes=max_nodes, max_graphs=max_graphs,
                     device="cpu")
    return jax_pred, port


@pytest.mark.parametrize("tie", [True, False])
def test_pack_single_sparse_native_identical_to_jax_and_numpy(tie):
    jax_pred, port = _predictors(tie)
    _, numpy_port = _predictors(tie, native_pack_on=False)
    graphs = synthetic_molecules(6, seed=5) + [
        {"graph": [], "node_features": [[0, 1, 0, 0, 0]]}]
    for g in graphs:
        edges = np.asarray(g["graph"], np.int32).reshape(-1, 3)
        got = port._pack_single_sparse_native(g, edges,
                                              len(g["node_features"]), 5)
        assert got is not None
        _assert_identical(got, jax_pred._pack_single_sparse_native(
            g, edges, len(g["node_features"]), 5))
        _assert_identical(got, numpy_port._pack_single_sparse(g, 5))
        _assert_identical(got, port._pack_single_sparse(g, 5))
        if "targets" in g:
            _assert_identical(got, next(iter(port._batches([g], 5))))


def _mol():
    return synthetic_molecules(1, seed=7)[0]


# (label, graph edit, feature width, message): rc -3, -5 and -6 raise;
# -1 and -2 are overflows; the numpy pack raises what the C code does.
SINGLE_ERRORS = {
    "rc-3 type": (lambda g: {**g, "graph": g["graph"] + [[0, 9, 1]]}, 5,
                  "edge type out of range"),
    "rc-5 vertex": (lambda g: {**g, "graph": g["graph"] + [[0, 1, 99]]}, 5,
                    "vertex id out of range"),
    "rc-6 width": (lambda g: {**g, "node_features": [
        [1.0] * (H + 2) for _ in g["node_features"]]}, H + 2,
                   "exceeds the model hidden size"),
    "rc-2 combined lane": (lambda g: {**g, "graph": [[0, 1, 1]] * 200}, 5,
                           "exceeds pack capacities"),
    "rc-1 lane": (lambda g: {**g, "graph": [[0, 1, 1]] * 20}, 5,
                  "exceeds pack capacities"),
}


@pytest.mark.parametrize("case", sorted(SINGLE_ERRORS))
def test_pack_single_sparse_error_codes_match_jax(case):
    edit, width, message = SINGLE_ERRORS[case]
    jax_pred, port = _predictors(True, max_nodes=32)
    if case == "rc-1 lane":
        # A per-type lane shorter than the combined one.
        port.caps = dataclasses.replace(port.caps, edges_per_type=16)
        jax_pred.caps = dataclasses.replace(jax_pred.caps, edges_per_type=16)
    g = edit(_mol())
    edges = np.asarray(g["graph"], np.int32).reshape(-1, 3)
    for pred in (port, jax_pred):
        with pytest.raises(ValueError, match=message):
            pred._pack_single_sparse_native(g, edges,
                                            len(g["node_features"]), width)
        with pytest.raises(ValueError, match=message):
            pred._pack_single_sparse(g, width)


def test_pack_single_sparse_rc4_falls_back_to_numpy_as_jax_does():
    """An envelope past the C code's 21-bit id fields (rc -4): both
    packages pack the graph with numpy instead, to the same batch."""
    jax_pred, port = _predictors(True)
    wide = packing.PackCapacities(nodes=2 ** 21, edges_per_type=64,
                                  graphs=4, edges_all=64)
    port.caps = wide
    jax_pred.caps = type(jax_pred.caps)(**dataclasses.asdict(wide))
    g = _mol()
    edges = np.asarray(g["graph"], np.int32).reshape(-1, 3)
    assert port._pack_single_sparse_native(
        g, edges, len(g["node_features"]), 5) is None
    got = port._pack_single_sparse(g, 5)
    want = jax_pred._pack_single_sparse(g, 5)
    for name in ("edge_sources", "edge_targets", "edge_mask",
                 "edge_sources_all", "edge_types_all", "edge_targets_all",
                 "targets", "target_mask"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    n = len(g["node_features"])
    for name in ("node_features", "node_graph_ids", "in_degrees"):
        np.testing.assert_array_equal(getattr(got, name)[:n + 8],
                                      getattr(want, name)[:n + 8])


# --------------------------------------------------- dispatch

VARIANT_PROCESSED = {
    "sparse": native_pack.SparseProcessed,
    "rgcn": native_pack.SparseProcessed,
    "dense": native_pack.DenseProcessed,
    "blocked": native_pack.DenseProcessed,
    "gcn": native_pack.GCNProcessed,
    "gcn_blocked": native_pack.DenseProcessed,
}


@pytest.mark.parametrize("how", ["default", "config", "env"])
@pytest.mark.parametrize("variant", sorted(VARIANT_PROCESSED))
def test_adapters_pack_natively_by_default(monkeypatch, variant, how):
    """The default config packs natively; `"native_pack": false` and
    GGNN_TPU_NO_NATIVE=1 select the numpy packers, as in JAX."""
    config = {**default_params_for(variant), "hidden_size": H,
              "batch_size": 8 if "blocked" in variant or variant == "dense"
              else 400}
    if how == "config":
        config["native_pack"] = False
    if how == "env":
        monkeypatch.setenv("GGNN_TPU_NO_NATIVE", "1")
    meta = DatasetMeta(30, 4, 5)
    adapter = variants.make_adapter(variant, config, meta)
    processed = adapter.preprocess(synthetic_molecules(30, seed=1), False)
    native_kind = VARIANT_PROCESSED[variant]
    assert isinstance(processed, native_kind) is (how == "default")
    adapter.plan(processed)
    batches = list(adapter.batches(processed, False))
    assert batches


@pytest.mark.parametrize("variant", sorted(VARIANT_PROCESSED))
def test_native_and_numpy_adapters_draw_alike_over_a_run(variant):
    """One RandomState through preprocessing and three training epochs,
    as the Runner draws it: the native and the numpy adapters give the
    same batches every epoch (no task_sample_ratios)."""
    config = {**default_params_for(variant), "hidden_size": H,
              "batch_size": 8 if "blocked" in variant or variant == "dense"
              else 500}
    raw = synthetic_molecules(150, seed=3)
    streams = {}
    for on in (True, False):
        adapter = variants.make_adapter(variant, {**config, "native_pack": on},
                                        DatasetMeta(30, 4, 5))
        rng = np.random.RandomState(0)
        processed = adapter.preprocess(raw, True, rng)
        adapter.plan(processed)
        streams[on] = [list(adapter.batches(processed, True, rng))
                       for _ in range(3)]
    for epoch, (got, want) in enumerate(zip(streams[True], streams[False])):
        _assert_streams(got, want, f"{variant} epoch {epoch}")


def test_bf16_dense_adapter_emits_a_bf16_adjacency():
    for variant, want in (("dense", torch.bfloat16),
                          ("blocked", torch.bfloat16),
                          ("gcn_blocked", np.dtype(np.float32))):
        config = {**default_params_for(variant), "hidden_size": H,
                  "batch_size": 8, "compute_dtype": "bfloat16",
                  "drop_remainder": False}
        adapter = variants.make_adapter(variant, config, DatasetMeta(30, 4, 5))
        processed = adapter.preprocess(synthetic_molecules(30, seed=1), False)
        for b in adapter.batches(processed, False):
            assert b.adjacency.dtype == want, variant
