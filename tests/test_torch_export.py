"""Deployment artifacts of the port (ggnn_tpu_torch/export.py): Predictor
-> .ggnnx (`torch.export` programs + weights) -> ExportedPredictor, on
the CPU. A counterpart of each test of tests/test_export.py (answers
equal to the live Predictor's at rtol 1e-6, the bound JAX pins: the
program runs the same ops in the same order), plus the weights against
`ggnn_tpu.export._flatten_params` of the same checkpoint restored in
JAX, each package's loader refusing the other's artifact, the programs
holding no weight and recording the kernels as ops, and
`torch.library.opcheck` of every op of the `ggnn_tpu_torch` namespace."""

import io
import json
import urllib.request
import zipfile
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from ggnn_tpu.export import _flatten_params as jax_flatten_params
from ggnn_tpu.export import export_predictor as jax_export_predictor
from ggnn_tpu.export import load_predictor as jax_load_predictor
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu_torch import cli
from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.export import (_flatten_params, _unflatten_params,
                                   export_predictor, load_predictor)
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.ops.kernels import edge_dot, ell_spmm, gather_floor
from ggnn_tpu_torch.ops.segment import segment_offsets
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.server import PredictionServer
from ggnn_tpu_torch.training.checkpoint import save_checkpoint
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.variants import make_adapter

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)
ENVELOPE = dict(max_nodes=128, max_graphs=16)
ATTENTION = {"use_propagation_attention": True, "use_edge_bias": True}
# The variants and their config overrides (hidden 8): the sparse GGNN
# with attention and on its per-type and per-edge routes, and the dense
# family with small batches.
VARIANTS = {
    "sparse": {}, "sparse_attention": ATTENTION, "rgcn": {},
    "sparse_per_type": {"combined_edge_lanes": False},
    "sparse_per_edge": {"aggregate_first": False},
    "gcn": {}, "gcn_blocked": {"batch_size": 8},
    "dense": {"batch_size": 8}, "blocked": {"batch_size": 8},
    "async": {"propagation_rounds": 2, "propagation_substeps": 20},
}


def _checkpoint(path, name, hidden=8, seed=0):
    """A random-weight checkpoint of VARIANTS[name], written by the port;
    returns (variant, path)."""
    variant = "sparse" if name.startswith("sparse") else name
    overrides = {"hidden_size": hidden, "native_pack": False,
                 **VARIANTS[name]}
    config = resolve_config(variant, config_json=json.dumps(overrides))
    gen = torch.Generator().manual_seed(seed)
    adapter = make_adapter(variant, config, DatasetMeta(64, 4, hidden))
    params = ModelParams(adapter.build_model(gen),
                         init_output_heads(gen, hidden, config["task_ids"]))
    save_checkpoint(str(path), config, params, 0, 0)
    return variant, str(path)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("artifact")
    _, ckpt = _checkpoint(tmp / "sparse.pickle", "sparse", hidden=16)
    predictor = Predictor.from_checkpoint(ckpt, "sparse", device="cpu",
                                          **ENVELOPE)
    path = str(tmp / "sparse.ggnnx")
    export_predictor(predictor, path)
    return path, predictor, ckpt


@pytest.fixture(scope="module")
def exported_pair(artifact):
    path, live, _ = artifact
    return live, load_predictor(path, device="cpu")


def _programs(path):
    """The artifact's meta and its loaded programs."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        programs = [torch.export.load(io.BytesIO(z.read(e["file"])))
                    for e in meta["functions"]]
    return meta, programs


def _kernel_calls(program):
    return Counter(str(n.target) for n in program.graph.nodes
                   if n.op == "call_function"
                   and str(n.target).startswith("ggnn_tpu_torch."))


def test_roundtrip_matches_live_predictor(exported_pair):
    live, exported = exported_pair
    assert exported.model is None  # no model code behind the artifact
    mols = synthetic_molecules(7, seed=5)
    np.testing.assert_allclose(exported(mols), live(mols), **TOL)
    # The single-request fast path dispatches into the same envelope.
    np.testing.assert_allclose(exported([mols[0]]), live([mols[0]]), **TOL)


def test_artifact_pins_numerics_against_model_drift(artifact, monkeypatch):
    """After the artifact is written, edits to the live model code do not
    change what it computes."""
    path, live, _ = artifact
    mols = synthetic_molecules(5, seed=6)
    want = live(mols)

    from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
    monkeypatch.setattr(
        SparseGGNN, "forward",
        lambda self, batch, **kw: torch.zeros_like(batch.node_features))
    # A live predictor now computes garbage...
    fresh = Predictor(live.variant, live.config, live.meta, live.params,
                      device="cpu", **ENVELOPE)
    assert not np.allclose(fresh(mols), want, rtol=1e-4, atol=1e-5)
    # ...but the artifact serves the pinned computation.
    np.testing.assert_allclose(load_predictor(path, device="cpu")(mols),
                               want, **TOL)


def test_dense_family_buckets_and_request_order(tmp_path):
    variant, ckpt = _checkpoint(tmp_path / "blocked.pickle", "blocked")
    live = Predictor.from_checkpoint(ckpt, variant, device="cpu")
    path = str(tmp_path / "blocked.ggnnx")
    export_predictor(live, path)
    meta, _ = _programs(path)
    # One program per bucket of the table.
    assert len(meta["functions"]) == len(live.adapter._bucket_sizes())
    exported = load_predictor(path, device="cpu")
    # Mixed sizes hit several buckets; the scatter back to request order
    # matches the live path.
    mols = synthetic_molecules(11, seed=7)
    np.testing.assert_allclose(exported(mols), live(mols), **TOL)


def _expected_kernel_calls(name, config):
    """The kernel ops a forward of VARIANTS[name] calls: B1 once a
    propagation step (sparse, rgcn) or an async substep, B3 and B1 once a
    step on the per-edge route, `edge_dot` and
    the weighted instance once a step with attention, the weighted
    instance once a GCN layer, and the GRU's K1 and K2 once a step of a
    GRU cell (every variant but rgcn's RNN cell and the GCNs)."""
    calls = _aggregation_calls(name, config)
    cell_steps = _gru_steps(name, config)
    if cell_steps:
        calls.update({"ggnn_tpu_torch.gru_gates.default": cell_steps,
                      "ggnn_tpu_torch.gru_update.default": cell_steps})
    return calls


def _gru_steps(name, config):
    """The GRU steps of a forward of VARIANTS[name]: none for rgcn's RNN
    cell and the GCNs; `dense`'s reference mode hard-codes a GRU of
    `num_timesteps` steps, `blocked` runs the sparse layers' steps."""
    if name in ("rgcn", "gcn", "gcn_blocked"):
        return 0
    if name == "dense":
        return config["num_timesteps"]
    if name == "async":
        return config["propagation_rounds"] * config["propagation_substeps"]
    return sum(config["layer_timesteps"])


def _aggregation_calls(name, config):
    ops = "ggnn_tpu_torch."
    if name in ("sparse", "rgcn", "sparse_per_type"):
        return {ops + "gather_segment_sum.default":
                sum(config["layer_timesteps"])}
    if name == "sparse_per_edge":
        steps = sum(config["layer_timesteps"])
        return {ops + "gather_rows.default": steps,
                ops + "gather_segment_sum.default": steps}
    if name == "sparse_attention":
        steps = sum(config["layer_timesteps"])
        return {ops + "edge_dot.default": steps,
                ops + "weighted_gather_segment_sum.default": steps}
    if name == "gcn":
        return {ops + "weighted_gather_segment_sum.default":
                config["num_timesteps"]}
    if name == "async":
        return {ops + "gather_segment_sum.default":
                config["propagation_rounds"]
                * config["propagation_substeps"]}
    return {}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_every_variant_exports(name, tmp_path):
    """Every variant (and the sparse GGNN with attention): export, load,
    predict as the live Predictor; the program holds no weight and calls
    each kernel the live forward calls as its op, as often."""
    variant, ckpt = _checkpoint(tmp_path / f"{name}.pickle", name)
    live = Predictor.from_checkpoint(ckpt, variant, device="cpu", **ENVELOPE)
    path = str(tmp_path / f"{name}.ggnnx")
    export_predictor(live, path)
    exported = load_predictor(path, device="cpu")
    mols = synthetic_molecules(5, seed=7)
    np.testing.assert_allclose(exported(mols), live(mols), **TOL)
    np.testing.assert_allclose(exported(mols[:1]), live(mols[:1]), **TOL)
    meta, programs = _programs(path)
    assert meta["runtime"] == "torch" and meta["variant"] == variant
    want = _expected_kernel_calls(name, live.config)
    assert meta["runtime"] == "torch" and meta["variant"] == variant
    for program in programs:
        assert not program.state_dict and not program.constants
        assert _kernel_calls(program) == want


def test_property_random_requests_match(exported_pair):
    """Hypothesis sweep: for random request graphs inside the envelope,
    the artifact and the live model agree (packing dispatch included)."""
    from hypothesis import given, settings, strategies as st

    live, exported = exported_pair

    @st.composite
    def requests(draw):
        graphs = []
        for _ in range(draw(st.integers(1, 4))):
            n = draw(st.integers(2, 12))
            edges = [[draw(st.integers(0, n - 1)), draw(st.integers(1, 3)),
                      draw(st.integers(0, n - 1))]
                     for _ in range(draw(st.integers(1, 16)))]
            graphs.append({"targets": [[0.0]], "graph": edges,
                           "node_features": [[1.0, 0.0]] * n})
        return graphs

    @settings(max_examples=20, deadline=None)
    @given(requests())
    def check(mols):
        np.testing.assert_allclose(exported(mols), live(mols), **TOL)

    check()


def test_unknown_batch_shape_is_a_clear_error(artifact):
    path, _, _ = artifact
    exported = load_predictor(path, device="cpu")
    exported._programs = {}  # an artifact missing the shape
    with pytest.raises(ValueError, match="not present in the artifact"):
        exported(synthetic_molecules(2, seed=8))


def _rewrite_meta(path, out, **changes):
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(out, "w") as zout:
        for item in zin.namelist():
            data = zin.read(item)
            if item == "meta.json":
                meta = json.loads(data)
                meta.update(changes)
                meta = {k: v for k, v in meta.items() if v is not None}
                data = json.dumps(meta).encode()
            zout.writestr(item, data)
    return out


def test_format_version_check(artifact, tmp_path):
    path, _, _ = artifact
    bad = _rewrite_meta(path, str(tmp_path / "bad.ggnnx"),
                        format_version=999)
    with pytest.raises(ValueError, match="format_version"):
        load_predictor(bad, device="cpu")


def test_artifact_is_pickle_free(artifact):
    """Loading a .ggnnx must not execute code: the weights travel as an
    npz of JSON-path-keyed arrays (read with allow_pickle=False), and
    the codec round-trips the live predictor's parameters."""
    path, live, _ = artifact
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        npz = np.load(io.BytesIO(z.read("params.npz")), allow_pickle=False)
        flat = {k: npz[k] for k in npz.files}
    assert "params.npz" in names
    assert not [n for n in names if n.endswith((".pkl", ".pickle"))]
    exported = load_predictor(path, device="cpu")
    named = dict(live.params.named_parameters())
    assert set(exported.params) == set(named)
    for name, value in named.items():
        torch.testing.assert_close(exported.params[name], value.detach(),
                                   rtol=0, atol=0)
    assert set(_flatten_params(_unflatten_params(flat))) == set(flat)


def test_params_codec_nested_lists():
    tree = {"layers": [{"w": np.arange(4.0).reshape(2, 2),
                        "cell": {"k": np.ones(3, np.float32)}},
                       {"w": np.zeros((1, 1))}],
            "heads": {"7": [np.float64(2.5) * np.ones(2)]}}
    out = _unflatten_params(_flatten_params(tree))
    assert isinstance(out["layers"], list) and len(out["layers"]) == 2
    np.testing.assert_array_equal(out["layers"][0]["cell"]["k"],
                                  np.ones(3, np.float32))
    assert out["layers"][0]["cell"]["k"].dtype == np.float32
    np.testing.assert_array_equal(out["heads"]["7"][0], [2.5, 2.5])
    with pytest.raises(TypeError, match="tuple"):
        _flatten_params({"a": (np.ones(1),)})
    with pytest.raises(TypeError, match="non-string"):
        _flatten_params({1: np.ones(1)})


def test_params_npz_equals_jax_flatten_params(artifact):
    """The artifact's weights are the JAX package's `_flatten_params` of
    the same checkpoint restored by the JAX Predictor: the same keys and
    the same arrays."""
    path, _, ckpt = artifact
    jax_params = JaxPredictor.from_checkpoint(ckpt, "sparse",
                                              **ENVELOPE).params
    want = jax_flatten_params(jax.device_get(jax_params))
    with zipfile.ZipFile(path) as z:
        npz = np.load(io.BytesIO(z.read("params.npz")), allow_pickle=False)
        got = {k: npz[k] for k in npz.files}
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_each_loader_refuses_the_other_packages_artifact(artifact,
                                                         tmp_path):
    path, _, ckpt = artifact
    jax_path = str(tmp_path / "jax.ggnnx")
    jax_export_predictor(JaxPredictor.from_checkpoint(ckpt, "sparse",
                                                      **ENVELOPE),
                         jax_path, platforms=("cpu",))
    with pytest.raises(ValueError, match="ggnn_tpu.export.load_predictor"):
        load_predictor(jax_path, device="cpu")
    with pytest.raises(ValueError, match="format_version"):
        jax_load_predictor(path)
    # A JAX artifact's meta with a torch marker but the JAX version is
    # refused by its version.
    marked = _rewrite_meta(jax_path, str(tmp_path / "marked.ggnnx"),
                           runtime="torch")
    with pytest.raises(ValueError, match="format_version"):
        load_predictor(marked, device="cpu")


def test_load_predictor_needs_cuda_without_device(artifact, monkeypatch):
    path, _, _ = artifact
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_predictor(path)


def test_cli_export_flag(artifact, tmp_path):
    _, _, ckpt = artifact
    out = str(tmp_path / "cli.ggnnx")
    rc = cli.main(["sparse", "--restore", ckpt, "--export-artifact", out,
                   "--quiet", "--device", "cpu", "--export-max-nodes", "64",
                   "--export-max-graphs", "8"])
    assert rc == 0
    exported = load_predictor(out, device="cpu")
    assert (exported.max_nodes, exported.max_graphs) == (64, 8)
    assert np.isfinite(exported(synthetic_molecules(3, seed=9))).all()
    # --export-artifact without --restore is a usage error.
    assert cli.main(["sparse", "--export-artifact", out, "--quiet"]) == 2


def test_server_serves_artifact(artifact):
    """The HTTP server takes a .ggnnx artifact, in-process and as
    `--checkpoint` of its CLI."""
    from ggnn_tpu_torch.server import main

    path, live, _ = artifact
    mols = synthetic_molecules(3, seed=10)
    server = PredictionServer(load_predictor(path, device="cpu"), port=0)
    server.warmup()
    server.start()
    host, port = server.address
    try:
        req = urllib.request.Request(
            f"http://{host}:{port}/predict",
            data=json.dumps({"graphs": mols}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = np.asarray(json.loads(resp.read())["outputs"])
        np.testing.assert_allclose(out, live(mols), rtol=1e-5, atol=1e-6)
    finally:
        server.shutdown()
    seen = {}

    def ready(server):
        host, port = server.address
        try:
            req = urllib.request.Request(
                f"http://{host}:{port}/predict",
                data=json.dumps({"graphs": mols}).encode())
            with urllib.request.urlopen(req, timeout=30) as resp:
                seen["out"] = np.asarray(json.loads(resp.read())["outputs"])
        finally:
            server.shutdown()

    main(["--checkpoint", path, "--port", "0", "--device", "cpu"],
         ready=ready)
    np.testing.assert_allclose(seen["out"], live(mols), rtol=1e-5,
                               atol=1e-6)


def _op_cases():
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(10, 6, generator=gen)
    seg = torch.sort(torch.randint(0, 7, (20,), generator=gen)).values
    src = torch.randint(0, 10, (20,), generator=gen, dtype=torch.int32)
    off = segment_offsets(seg.to(torch.int32), 7)
    w = torch.randn(20, generator=gen)
    ops = torch.ops.ggnn_tpu_torch
    return {
        "gather_segment_sum": (ops.gather_segment_sum.default,
                               (h, src, off, 7)),
        "segment_scatter_sum": (ops.segment_scatter_sum.default,
                                (h, src, off, 7)),
        "weighted_gather_segment_sum": (
            ops.weighted_gather_segment_sum.default, (h, src, w, off, 7)),
        "weighted_segment_scatter_sum": (
            ops.weighted_segment_scatter_sum.default, (h, src, w, off, 7)),
        "gather_rows": (ops.gather_rows.default,
                        (h, src.view(4, 5), 1, False)),
        "edge_dot": (ops.edge_dot.default, (h, src, h, src)),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_opcheck_on_the_cpu(name):
    """`torch.library.opcheck` (schema, autograd registration, fake
    implementation, AOT dispatch with dynamic shapes) of each op, and the
    op equal to its wrapper's plain version."""
    op, args = _op_cases()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    plain = {
        "gather_segment_sum": ell_spmm.gather_segment_sum_reference,
        "segment_scatter_sum": ell_spmm.segment_scatter_sum_reference,
        "weighted_gather_segment_sum":
            ell_spmm.weighted_gather_segment_sum_reference,
        "weighted_segment_scatter_sum":
            ell_spmm.weighted_gather_segment_sum_reference,
        "gather_rows": lambda h, src, unroll, streaming:
            gather_floor.gather_rows_reference(h, src),
        "edge_dot": edge_dot.edge_dot_reference,
    }[name]
    torch.testing.assert_close(op(*args), plain(*args), rtol=0, atol=0)
