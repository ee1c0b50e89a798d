"""Inference serving: checkpoint -> batched predictor on the GPU.

Port of `ggnn_tpu/serving.py:Predictor` for every variant: `sparse`,
`rgcn`, `dense`, `blocked`, `gcn`, `gcn_blocked` and `async`. A
`Predictor`

  * loads a pickle checkpoint of either package, or a reference TF1
    pickle (compat/tf1.py), without any training data; the edge-type
    count comes from the saved edge weights (1 for the GCN variants,
    which discard edge types; the count of per-type leaves, or a legacy
    stacked array, for `async`);
  * packs sparse-family, `gcn` and `async` requests into a fixed serving
    envelope (`max_nodes`, `max_graphs`), so every batch has the same
    shapes, and micro-batches requests that exceed it; dense-family
    requests (`dense`, `blocked`, `gcn_blocked`) are packed bucket by
    bucket into batches of the config's `batch_size` graphs (the bucket
    table is the envelope), and the answers are put back in request
    order;
  * keeps, for `async`, each request topology's schedule and each
    one-graph request's packed batch, in caches bounded by entries and
    bytes under one lock, so a molecule scored again skips the schedule
    and the packing;
  * runs the forward pass on the GPU unless asked otherwise
    (`device="cpu"`): the sparse family and `async` (its plain path,
    one receiver sum a substep) through the gather + segment-sum CUDA
    kernel, `gcn` through its weighted instance, the dense family
    through cuBLAS products. Where JAX jits the forward, the port
    replays it: on the card each packed-batch shape is captured once
    into a CUDA graph and replayed (`utils/timing.py:StepCache`), each
    batch copied from the host into the graph's buffers; on the CPU it
    runs eagerly.

Example:
    predictor = Predictor.from_checkpoint("run_model_best.pickle",
                                          variant="sparse")
    mu = predictor(molecule_jsons)      # np.ndarray [K, n_graphs]

The HTTP server (server.py) and the exported artifacts (export.py) run
on this Predictor's host pipeline. As in JAX, the sparse family and
`gcn` pack through the native C++ packer (data/native_pack.py; a
one-graph sparse request through its `pack_single_sparse`) when the
config's `native_pack` is true (the default) and the library builds, and
through the numpy packers otherwise; the dense family packs through the
adapter, which makes the same choice. A model with `compute_dtype:
bfloat16` serves the dense family a bf16 adjacency when the native
packer runs (as JAX's does), else f32; the model casts either way.
"""

import collections
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ggnn_tpu_torch.data import async_schedule, native_pack, packing
from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.graph import DenseGraphBatch, GraphBatch
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.native import get_lib
from ggnn_tpu_torch.training.checkpoint import (_load_payload, _looks_tf1,
                                                _sanitize,
                                                restore_checkpoint)
from ggnn_tpu_torch.training.config import default_params_for
from ggnn_tpu_torch.training.variants import (_dense_adjacency_dtype,
                                              _use_native, make_adapter)
from ggnn_tpu_torch.utils.device import resolve_device
from ggnn_tpu_torch.utils.timing import StepCache

_DENSE_FAMILY = ("dense", "blocked", "gcn_blocked")
# Packed into the fixed envelope.
_ENVELOPE_FAMILY = ("sparse", "rgcn", "gcn", "async")
_SERVED = _ENVELOPE_FAMILY + _DENSE_FAMILY
# Where the models keep their edge weights [T, H, H]: the layered ones
# (sparse, rgcn, blocked) per layer, the reference dense model once; a
# legacy async checkpoint stacks its per-type leaves there too.
_EDGE_WEIGHT_KEYS = ("['params']['graph']['layers'][0]['edge_weights']",
                     "['params']['graph']['edge_weights']")
# The async model's per-type [H, H] leaves: <prefix>[t].
_ASYNC_TYPE_PREFIX = "['params']['graph']['edge_weights']["
# The same in a TF1 reference pickle (compat/tf1.py).
_TF1_LAYER_WEIGHTS = "graph_model/gnn_layer_0/gnn_edge_weights_0"
_TF1_DENSE_WEIGHTS = "graph_model/Variable"
_TF1_ASYNC_TYPE_PREFIX = "graph_model/gnn_edge_weights_typ"


def _check_variant(variant: str) -> None:
    if variant not in _SERVED:
        # Raises ValueError for an unknown variant.
        default_params_for(variant)


def _infer_geometry(payload: Dict, variant: str, config: Dict):
    """(num_edge_types, hidden): T from the saved edge-weight tensor (1
    for the GCN variants, which have none; for `async` the count of its
    per-type leaves, or a legacy stacked tensor's rows), hidden from the
    config. A TF1 reference pickle names them by TF variable
    (`ggnn_tpu/serving.py:57-62`): the layered models' first layer
    [T*H, H], the reference dense model's `Variable` [T, H, H], the
    async model's per-type `gnn_edge_weights_typ{t}`. An Orbax
    directory names them by their sanitized keys."""
    weights = payload["weights"]
    hidden = int(config["hidden_size"])
    edge_keys, async_prefix = _EDGE_WEIGHT_KEYS, _ASYNC_TYPE_PREFIX
    if payload.get("sanitized_keys"):
        edge_keys = tuple(map(_sanitize, edge_keys))
        async_prefix = _sanitize(async_prefix[:-1]) + "."
    if variant in ("gcn", "gcn_blocked"):
        return 1, hidden
    if _looks_tf1(payload):
        names = {str(k).split(":")[0]: v for k, v in weights.items()}
        if variant == "async":
            count = sum(1 for k in names
                        if k.startswith(_TF1_ASYNC_TYPE_PREFIX))
            if count:
                return count, hidden
        elif _TF1_LAYER_WEIGHTS in names:
            return int(np.shape(names[_TF1_LAYER_WEIGHTS])[0]) // hidden, hidden
        elif _TF1_DENSE_WEIGHTS in names:
            return int(np.shape(names[_TF1_DENSE_WEIGHTS])[0]), hidden
    if variant == "async":
        count = sum(1 for k in weights if k.startswith(async_prefix))
        if count:
            return count, hidden
    if variant in _SERVED:
        for key in edge_keys:
            if key in weights:
                return int(np.shape(weights[key])[0]), hidden
    raise ValueError(
        f"cannot infer geometry for variant '{variant}' from checkpoint "
        f"keys {sorted(weights)[:6]}...")


def _nbytes(value) -> int:
    """Host bytes of the numpy arrays in a batch or schedule (dataclasses
    and tuples of them)."""
    if isinstance(value, tuple):
        return sum(_nbytes(v) for v in value)
    if dataclasses.is_dataclass(value):
        return sum(_nbytes(getattr(value, f.name))
                   for f in dataclasses.fields(value))
    return int(getattr(value, "nbytes", 0))


class _BoundedCache:
    """An LRU map capped by entries and by the host bytes of its values;
    a value larger than the byte cap is not kept. Not thread-safe: the
    Predictor holds its lock around every call."""

    def __init__(self, max_entries: int, max_bytes: int):
        self.max_entries, self.max_bytes = max_entries, max_bytes
        self.entries = collections.OrderedDict()
        self.nbytes = 0

    def get(self, key):
        hit = self.entries.get(key)
        if hit is None:
            return None
        self.entries.move_to_end(key)
        return hit[0]

    def put(self, key, value) -> None:
        size = _nbytes(value)
        if key in self.entries or size > self.max_bytes:
            return
        self.entries[key] = (value, size)
        self.nbytes += size
        while (len(self.entries) > self.max_entries
               or self.nbytes > self.max_bytes):
            _, (_, old) = self.entries.popitem(last=False)
            self.nbytes -= old


def _topology_key(g: Dict):
    """A request graph's topology: its node count and edge bytes, the one
    key of both async caches."""
    edges = np.asarray(g.get("graph", ()), np.int64).reshape(-1, 3)
    return len(g["node_features"]), edges.tobytes()


def _with_dtype(adjacency, dtype):
    """A dense batch's adjacency in `dtype` (np.float32 or
    torch.bfloat16; both hold its 0/1 or normalised entries as the JAX
    package's batches do): numpy has no bf16, so a bf16 adjacency is a
    host torch tensor."""
    if dtype == torch.bfloat16:
        if isinstance(adjacency, torch.Tensor):
            return adjacency.to(torch.bfloat16)
        return torch.from_numpy(adjacency).to(torch.bfloat16)
    if isinstance(adjacency, torch.Tensor):
        return adjacency.to(torch.float32).numpy()
    return adjacency


def _chain_graph(n_nodes: int, annotation_size: int, n_tasks: int) -> Dict:
    """A minimal valid request graph: a chain of `n_nodes` vertices with
    type-1 edges (valid for any num_edge_types >= 1)."""
    return {
        "targets": [[0.0] for _ in range(n_tasks)],
        "graph": [[i, 1, i + 1] for i in range(n_nodes - 1)],
        "node_features": [[1.0] * annotation_size for _ in range(n_nodes)],
    }


def serve_forward(params, task_ids, batch) -> torch.Tensor:
    """Predictions [K, G] of a batch on the parameters' device: the
    model's forward and readout. `params` has the `ModelParams` layout
    (`graph`, `heads`); export.py traces this function."""
    model = params.graph
    final = model(batch)
    return model.readout(params.heads, task_ids, final, batch)


class Predictor:
    """Batched forward pass over a fixed serving envelope (sparse family,
    `gcn` and `async`) or the bucket table (dense family)."""

    # The async caches' bounds, those of the JAX Predictor: a schedule per
    # topology, a packed one-graph batch per topology and width.
    ASYNC_SCHEDULE_CACHE = (2048, 256 * 2**20)
    ASYNC_BATCH_CACHE = (256, 256 * 2**20)

    def __init__(self, variant: str, config: Dict, meta: DatasetMeta,
                 params: ModelParams, max_nodes: int = 2048,
                 max_graphs: int = 256, device=None):
        _check_variant(variant)
        self.device = resolve_device(device)
        self.variant = variant
        self.config = dict(config)
        self.meta = meta
        self.task_ids = list(config["task_ids"])
        self.max_nodes = max_nodes
        self.max_graphs = max_graphs
        if variant in _DENSE_FAMILY:
            # No envelope: a dense batch is `batch_size` graphs of one
            # bucket, and every graph is answered (no remainder dropping).
            self.adapter = make_adapter(variant, self.config, meta,
                                        drop_remainder=False)
        elif variant == "async":
            # No segment plan: the model takes its plain path.
            self.caps = async_schedule.AsyncCapacities(
                nodes=max_nodes, graphs=max_graphs,
                initial_nodes=max_nodes,
                sending_edges=max(8 * max_nodes, 64),
                receiving_nodes=max_nodes)
            self._cache_lock = threading.Lock()
            self._schedules = _BoundedCache(*self.ASYNC_SCHEDULE_CACHE)
            self._single_batches = _BoundedCache(*self.ASYNC_BATCH_CACHE)
        else:
            self.caps = packing.PackCapacities(
                nodes=max_nodes,
                edges_per_type=max(8 * max_nodes, 64),
                graphs=max_graphs,
                # type-combined lane envelope (~4 bonds/node x 2
                # directions covers molecular graphs with headroom)
                edges_all=max(8 * max_nodes, 64),
            )
        self.params = self._place(params)
        # The forward JAX jits (`ggnn_tpu/serving.py:150-158`): on the
        # card one CUDA graph a packed-batch shape, captured at its first
        # batch and replayed; eager on the CPU. Its lock holds each
        # batch's copy in, replay and read back, so threads may share the
        # Predictor.
        self._graphs = StepCache(lambda batch: self._serve(batch),
                                 self.device, name="serving forward")

    def _place(self, params: ModelParams):
        """The parameters as the forward uses them, on `self.device`."""
        return params.to(self.device).eval()

    def _serve(self, batch) -> torch.Tensor:
        """Predictions [K, G] of one batch on the device."""
        with torch.inference_mode():
            return serve_forward(self.params, self.task_ids, batch)

    def _forward(self, batch) -> np.ndarray:
        """Predictions [K, G] of one packed batch, a host copy read before
        the next batch's replay overwrites the graph's output."""
        return self._graphs(
            batch, read=lambda out: out.to("cpu", copy=True).numpy())

    def graph_count(self) -> int:
        """The CUDA graphs captured so far, one a batch shape (0 on the
        CPU)."""
        return len(self._graphs.graphs)

    def example_graphs(self, annotation_size: Optional[int] = None
                       ) -> List[Dict]:
        """Request graphs, one for each batch shape the Predictor packs:
        a 2-node chain for the envelope, or for the dense family a chain
        of each bucket's size. Each alone takes the 1-graph path, which
        packs the shape a larger request does."""
        ann = annotation_size or self.meta.annotation_size
        # Targets are indexed by task id: sized by the largest id.
        n_tasks = max(self.task_ids) + 1
        if self.variant in _DENSE_FAMILY:
            sizes = self.adapter._bucket_sizes()
            sizes = packing.DENSE_BUCKET_SIZES if sizes is None else sizes
            return [_chain_graph(int(v), ann, n_tasks) for v in sizes]
        return [_chain_graph(2, ann, n_tasks)]

    # ------------------------------------------------------------ load

    @classmethod
    def from_checkpoint(cls, path: str, variant: str = "sparse",
                        max_nodes: int = 2048, max_graphs: int = 256,
                        annotation_size: Optional[int] = None,
                        config_overrides: Optional[Dict] = None,
                        device=None) -> "Predictor":
        """`config_overrides` merge over the checkpoint's embedded config
        for the serving surface. They do not take part in the restore
        compat check and must not change weight geometry."""
        _check_variant(variant)
        device = resolve_device(device)
        payload = _load_payload(path)
        config = dict(payload["params"])
        if _looks_tf1(payload):
            # A TF1 reference pickle may save a partial config: the
            # variant's defaults fill the rest.
            config = {**default_params_for(variant), **config}
        num_edge_types, hidden = _infer_geometry(payload, variant, config)
        meta = DatasetMeta(max_num_vertices=max_nodes,
                           num_edge_types=num_edge_types,
                           annotation_size=annotation_size or hidden)
        # A fresh skeleton from the config's shapes, then the restore
        # (config compat check, per-leaf shape check). The optimizer
        # state in the checkpoint is ignored for serving.
        generator = torch.Generator().manual_seed(0)
        skeleton = ModelParams(
            graph=make_adapter(variant, config, meta).build_model(generator),
            heads=init_output_heads(generator, config["hidden_size"],
                                    config["task_ids"]))
        restored, _, _ = restore_checkpoint(
            path, config, skeleton, log=lambda *a: None, payload=payload,
            variant=variant, num_edge_types=num_edge_types)
        if config_overrides:
            config = {**config, **config_overrides}
        return cls(variant, config, meta, restored, max_nodes=max_nodes,
                   max_graphs=max_graphs, device=device)

    # ----------------------------------------------------------- batches

    def _batches(self, raw_graphs: Sequence, annotation_size: int):
        """The envelope batches of a sparse-family, `gcn` or `async`
        request."""
        cfg = self.config
        # The packer's fit check is strict (`offset + n < budget`,
        # reference semantics), so budget = envelope + 1 lets a request
        # graph of exactly max_nodes through — the arrays are sized by
        # caps.nodes either way.
        node_budget = self.caps.nodes + 1
        if self.variant == "async":
            processed = [self._async_processed(g) for g in raw_graphs]
            return async_schedule.pack_async_batches(
                processed, self.meta.num_edge_types, node_budget, self.caps,
                cfg["propagation_rounds"], cfg["propagation_substeps"],
                cfg["hidden_size"], annotation_size, False, None)
        if self.variant == "gcn":
            if _use_native(cfg):
                processed = native_pack.preprocess_gcn_native(
                    raw_graphs, self.task_ids, {}, False)
                return native_pack.pack_gcn_batches_native(
                    processed, node_budget, self.caps, cfg["hidden_size"],
                    annotation_size, False, None)
            processed = packing.preprocess_gcn(raw_graphs, self.task_ids,
                                               {}, False)
            return packing.pack_gcn_batches(
                processed, node_budget, self.caps, cfg["hidden_size"],
                annotation_size, False, None)
        if _use_native(cfg):
            processed = native_pack.preprocess_sparse_native(
                raw_graphs, self.meta.num_edge_types, cfg["tie_fwd_bkwd"],
                self.task_ids, {}, False)
            return native_pack.pack_sparse_batches_native(
                processed, self.meta.num_edge_types, cfg["tie_fwd_bkwd"],
                node_budget, self.caps, cfg["hidden_size"], annotation_size,
                False, None)
        processed = packing.preprocess_sparse(
            raw_graphs, self.meta.num_edge_types, cfg["tie_fwd_bkwd"],
            self.task_ids, {}, False)
        return packing.pack_sparse_batches(
            processed, self.meta.num_edge_types, node_budget,
            self.caps, cfg["hidden_size"], annotation_size, False, None)

    # ------------------------------------------------------------- call

    def __call__(self, raw_graphs: Sequence) -> np.ndarray:
        """Predict per-task values for raw graph JSON dicts.

        Returns [K, len(raw_graphs)], column i the answer to graph i.
        Sparse-family requests larger than the serving envelope are
        micro-batched in request order; dense-family requests are packed
        bucket by bucket and their answers scattered back to request
        order.
        """
        if not raw_graphs:
            raise ValueError("empty prediction request")
        first = raw_graphs[0].get("node_features") or []
        if not first:
            raise ValueError(
                "graph 0: node_features must be non-empty with a "
                "consistent width across the request")
        annotation_size = len(first[0])
        for i, g in enumerate(raw_graphs):
            if (not g.get("node_features")
                    or len(g["node_features"][0]) != annotation_size):
                raise ValueError(
                    f"graph {i}: node_features must be non-empty with a "
                    f"consistent width ({annotation_size}) across the "
                    "request")
            # Vertex-id range check at the entry: an id past this graph's
            # node count would silently gather/scatter ANOTHER request
            # graph's rows in a packed batch.
            n = len(g["node_features"])
            edges = np.asarray(g.get("graph", ()),
                               np.int64).reshape(-1, 3)
            if edges.size and (edges[:, [0, 2]].min() < 0
                               or edges[:, [0, 2]].max() >= n):
                raise ValueError(
                    f"graph {i}: edge vertex id out of range [0, {n})")
        if self.variant in _DENSE_FAMILY:
            return self._call_dense(raw_graphs, annotation_size)
        if len(raw_graphs) == 1 and self.variant in ("sparse", "rgcn"):
            batch = self._pack_single_sparse(raw_graphs[0], annotation_size)
            return self._forward(batch)[:, :1]
        if len(raw_graphs) == 1 and self.variant == "async":
            batch = self._pack_single_async(raw_graphs[0], annotation_size)
            return self._forward(batch)[:, :1]
        outs: List[np.ndarray] = []
        for batch in self._batches(raw_graphs, annotation_size):
            outs.append(self._forward(batch)[:, :int(batch.num_graphs)])
        return np.concatenate(outs, axis=1)

    def _pack_single_sparse_native(self, g: Dict, edges: np.ndarray,
                                   n: int, annotation_size: int):
        """The native one-graph pack (native/packer.cpp:
        pack_single_sparse): one C call fills every array. None when the
        config's `native_pack` is false, the library is unavailable or
        the envelope exceeds the C code's 21-bit id fields (rc -4); the
        numpy pack then takes over."""
        if not _use_native(self.config):
            return None
        lib = get_lib()
        caps = self.caps
        t_dim = self.meta.num_edge_types
        hidden = self.config["hidden_size"]
        ea = int(caps.edges_all or 0)
        edge_sources = np.empty((t_dim, caps.edges_per_type), np.int32)
        edge_targets = np.empty_like(edge_sources)
        edge_mask = np.empty((t_dim, caps.edges_per_type), np.float32)
        comb_src = np.empty(max(ea, 1), np.int32)
        comb_typ = np.empty_like(comb_src)
        comb_tgt = np.empty_like(comb_src)
        comb_mask = np.empty(max(ea, 1), np.float32)
        in_degrees = np.empty((caps.nodes, t_dim), np.float32)
        node_features = np.empty((caps.nodes, hidden), np.float32)
        node_graph_ids = np.empty(caps.nodes, np.int32)
        feats = np.ascontiguousarray(g["node_features"], dtype=np.float32)
        edges_c = np.ascontiguousarray(edges)
        rc = lib.pack_single_sparse(
            edges_c.ctypes.data, len(edges), feats.ctypes.data, n,
            annotation_size, t_dim, int(self.config["tie_fwd_bkwd"]),
            caps.nodes, caps.edges_per_type, ea, hidden, caps.graphs,
            edge_sources.ctypes.data, edge_targets.ctypes.data,
            edge_mask.ctypes.data,
            comb_src.ctypes.data, comb_typ.ctypes.data,
            comb_tgt.ctypes.data, comb_mask.ctypes.data,
            in_degrees.ctypes.data, node_features.ctypes.data,
            node_graph_ids.ctypes.data)
        if rc == -4:
            return None  # ids exceed the C code's key fields
        if rc == -3:
            num_fwd = t_dim if self.config["tie_fwd_bkwd"] else t_dim // 2
            raise ValueError(
                f"edge type out of range [1, {num_fwd}] in request graph")
        if rc == -5:
            raise ValueError(
                f"edge vertex id out of range [0, {n}) in request graph")
        if rc == -6:
            raise ValueError(
                f"request feature width {annotation_size} exceeds the "
                f"model hidden size {hidden}")
        if rc != 0:
            raise ValueError(
                f"graph with {2 * len(edges)} directed edges exceeds "
                f"pack capacities {self.caps}")
        targets, target_mask = self._single_graph_targets(g, caps.graphs)
        extra = {}
        if ea:
            extra = dict(edge_sources_all=comb_src, edge_types_all=comb_typ,
                         edge_targets_all=comb_tgt, edge_mask_all=comb_mask)
        return GraphBatch(
            node_features=node_features, node_graph_ids=node_graph_ids,
            edge_sources=edge_sources, edge_targets=edge_targets,
            edge_mask=edge_mask, in_degrees=in_degrees,
            targets=targets, target_mask=target_mask,
            num_graphs=np.int32(1), num_nodes=np.int32(n), **extra)

    def _pack_single_sparse(self, g: Dict,
                            annotation_size: int) -> GraphBatch:
        """One-graph pack (the latency path): the same batch, bit for
        bit, as `_batches` on a 1-graph request, from the native
        `pack_single_sparse` where it serves, else assembled with numpy
        array ops instead of the per-graph corpus pipeline. Semantics
        mirrored from data/packing.py: 0-based types with tied/untied
        backward edges, per-type lanes (target, source)-sorted with
        dump-slot padding, the type-combined (target, type)-sorted lane,
        per-type in-degrees, and the labels->values/mask convention."""
        caps = self.caps
        t_dim = self.meta.num_edge_types
        tie = self.config["tie_fwd_bkwd"]
        num_fwd = t_dim if tie else t_dim // 2
        hidden = self.config["hidden_size"]
        n = len(g["node_features"])
        if n >= caps.nodes + 1:
            raise ValueError(
                f"graph with {n} nodes exceeds pack capacities {caps}")

        edges = np.asarray(g.get("graph", ()), dtype=np.int32).reshape(-1, 3)
        native = self._pack_single_sparse_native(g, edges, n,
                                                 annotation_size)
        if native is not None:
            return native
        raw_t = edges[:, 1]
        if raw_t.size and not (1 <= raw_t.min() and raw_t.max() <= num_fwd):
            bad = raw_t[(raw_t < 1) | (raw_t > num_fwd)][0]
            raise ValueError(f"edge type {bad} out of range [1, {num_fwd}]")
        ends = edges[:, (0, 2)]
        if ends.size and not (0 <= ends.min() and ends.max() < n):
            raise ValueError(
                f"edge vertex id out of range [0, {n}) in request graph")
        src = np.concatenate([edges[:, 0], edges[:, 2]])
        dst = np.concatenate([edges[:, 2], edges[:, 0]])
        typ = np.concatenate([raw_t - 1,
                              raw_t - 1 if tie else raw_t - 1 + num_fwd])
        if caps.edges_all and len(src) > caps.edges_all:
            raise ValueError(
                f"graph with {len(src)} directed edges exceeds the "
                f"combined-lane capacity in {caps}")

        node_features = np.zeros((caps.nodes, hidden), np.float32)
        node_features[:n, :annotation_size] = g["node_features"]
        node_graph_ids = np.full(caps.nodes, caps.graphs, np.int32)
        node_graph_ids[:n] = 0
        in_degrees = np.zeros((caps.nodes, t_dim), np.float32)
        np.add.at(in_degrees, (dst, typ), 1.0)

        e_cap = caps.edges_per_type
        edge_sources = np.zeros((t_dim, e_cap), np.int32)
        edge_targets = np.full((t_dim, e_cap), caps.nodes, np.int32)
        edge_mask = np.zeros((t_dim, e_cap), np.float32)
        # One (type, target, source) sort yields every per-type lane in
        # its packed order; per-type slots are positions within type.
        order = np.lexsort((src, dst, typ))
        s_s, d_s, t_s = src[order], dst[order], typ[order]
        counts = np.bincount(t_s, minlength=t_dim)
        if np.any(counts > e_cap):
            raise ValueError(
                f"graph with {counts.max()} edges of one type exceeds "
                f"pack capacities {caps}")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slots = np.arange(len(t_s)) - starts[t_s]
        edge_sources[t_s, slots] = s_s
        edge_targets[t_s, slots] = d_s
        edge_mask[t_s, slots] = 1.0

        targets, target_mask = self._single_graph_targets(g, caps.graphs)

        common = dict(
            node_features=node_features,
            node_graph_ids=node_graph_ids,
            edge_sources=edge_sources,
            edge_targets=edge_targets,
            edge_mask=edge_mask,
            in_degrees=in_degrees,
            targets=targets,
            target_mask=target_mask,
            num_graphs=np.int32(1),
            num_nodes=np.int32(n),
        )
        if caps.edges_all:
            # (target, type)-sorted combined lane; ties keep source
            # order, matching build_combined_lane's stable lexsort over
            # the (target, source)-sorted per-type lanes.
            order2 = np.lexsort((s_s, t_s, d_s))
            ea = caps.edges_all
            out_src = np.zeros(ea, np.int32)
            out_tgt = np.full(ea, caps.nodes, np.int32)
            out_typ = np.zeros(ea, np.int32)
            out_mask = np.zeros(ea, np.float32)
            m = len(order2)
            out_src[:m] = s_s[order2]
            out_tgt[:m] = d_s[order2]
            out_typ[:m] = t_s[order2]
            out_mask[:m] = 1.0
            common.update(edge_sources_all=out_src, edge_types_all=out_typ,
                          edge_targets_all=out_tgt, edge_mask_all=out_mask)
        return GraphBatch(**common)

    def _single_graph_targets(self, g: Dict, graph_cap: int):
        """The packers' single-graph targets convention: labels ->
        values/mask on an optional "targets" key, zero-padded
        [K, graph_cap] with column 0 real."""
        values, mask = packing._labels_to_values_and_mask(
            packing._extract_labels(g, self.task_ids) if "targets" in g
            else [None] * len(self.task_ids))
        targets = np.zeros((len(self.task_ids), graph_cap), np.float32)
        target_mask = np.zeros_like(targets)
        targets[:, 0] = values
        target_mask[:, 0] = mask
        return targets, target_mask

    def _async_processed(self, g: Dict) -> Dict:
        """The processed entry of one async request graph: its flat
        schedule tables from the topology cache (made once per topology,
        outside the lock), its features and labels from the request."""
        cfg = self.config
        key = _topology_key(g)
        with self._cache_lock:
            flat = self._schedules.get(key)
        if flat is None:
            schedules = async_schedule.graph_to_propagation_schedules(
                g.get("graph", ()), self.meta.num_edge_types,
                cfg["tie_fwd_bkwd"], cfg["propagation_rounds"],
                cfg["propagation_substeps"],
                num_nodes=len(g["node_features"]))
            flat = async_schedule._flatten_schedules(
                schedules, cfg["propagation_substeps"],
                self.meta.num_edge_types)
            with self._cache_lock:
                self._schedules.put(key, flat)
        labels = (packing._extract_labels(g, self.task_ids) if "targets" in g
                  else [None] * len(self.task_ids))
        return {"init": np.asarray(g["node_features"], dtype=np.float32),
                "flat_schedules": flat, "labels": labels}

    def _pack_single_async(self, g: Dict, annotation_size: int):
        """One-graph async batch (the latency path): every schedule leaf
        depends only on the topology, so a topology seen before takes its
        cached batch with new features and targets; a new one is packed
        by `_batches`. The swapped leaves follow the packer's conventions
        (features zero-padded to [nodes, hidden], targets [K, graphs]
        with column 0 real), so the batch equals `_batches([g])`'s."""
        key = _topology_key(g) + (annotation_size,)
        with self._cache_lock:
            cached = self._single_batches.get(key)
        if cached is None:
            (batch,) = list(self._batches([g], annotation_size))
            with self._cache_lock:
                self._single_batches.put(key, batch)
            return batch
        n = len(g["node_features"])
        feats = np.zeros((cached.node_capacity, int(self.config["hidden_size"])),
                         np.float32)
        feats[:n, :annotation_size] = np.asarray(g["node_features"],
                                                 dtype=np.float32)
        targets, target_mask = self._single_graph_targets(
            g, cached.graph_capacity)
        return dataclasses.replace(cached, node_features=feats,
                                   targets=targets, target_mask=target_mask)

    def _pack_single_dense(self, g: Dict,
                           annotation_size: int) -> DenseGraphBatch:
        """One-graph bucket pack (the dense family's latency path): the
        graph's bucket, row 0 of a zeroed [batch_size, ...] batch filled
        directly — the same batch, leaf for leaf, as the corpus packer's
        for a 1-graph request, without its bucketed-dict plumbing.
        Semantics of data/packing.py: preprocess_dense (or
        preprocess_gcn_dense) + pack_dense_batches (bucket by
        max(max_vertex + 1, rows), phantom vertices rejected, [T, V, V]
        adjacency or the [1, V, V] normalised GCN block, labels ->
        values/mask)."""
        cfg = self.config
        sizes = self.adapter._bucket_sizes()
        sizes = packing.DENSE_BUCKET_SIZES if sizes is None else sizes
        edges = g.get("graph", ())
        n = len(g["node_features"])
        max_vertex = max((v for e in edges for v in (e[0], e[2])),
                         default=-1)
        if max_vertex >= n:
            raise ValueError(
                f"graph 0: edge vertex id {max_vertex} >= "
                f"number of node-feature rows {n}")
        needed = max(max_vertex + 1, n)
        if needed > int(sizes[-1]):
            raise ValueError(
                f"graph with {needed} vertices exceeds the largest "
                f"bucket ({int(sizes[-1])})")
        v = int(sizes[int(np.argmax(sizes >= needed))])
        b_cap = int(cfg["batch_size"])
        t_dim = self.meta.num_edge_types

        init = np.zeros((b_cap, v, int(cfg["hidden_size"])), np.float32)
        init[0, :n, :annotation_size] = np.asarray(g["node_features"],
                                                   dtype=np.float32)
        node_mask = np.zeros((b_cap, v), np.float32)
        node_mask[0, :n] = 1.0
        adjacency = np.zeros((b_cap, t_dim, v, v), np.float32)
        if self.variant == "gcn_blocked":
            adjacency[0] = packing.normalized_adjacency_block(edges, v, n)
        else:
            adjacency[0] = packing.build_dense_adjacency(
                edges, v, t_dim, cfg["tie_fwd_bkwd"])
        targets, target_mask = self._single_graph_targets(g, b_cap)
        return DenseGraphBatch(
            node_features=init,
            adjacency=_with_dtype(adjacency, self._dense_adjacency_dtype()),
            node_mask=node_mask, targets=targets, target_mask=target_mask,
            num_graphs=np.int32(1))

    def _dense_adjacency_dtype(self):
        """The dense-family serving batches' adjacency dtype: the
        training pipeline's (bf16 under `compute_dtype: bfloat16` when
        the native packer runs, else f32; `gcn_blocked` f32 always). The
        ExportedPredictor reads it from its artifact instead: whether the
        serving host has the native library must not change the dispatch
        key an artifact was exported with."""
        if self.variant != "gcn_blocked" and _use_native(self.config):
            return _dense_adjacency_dtype(self.config)
        return np.float32

    def _dense_batches(self, raw_graphs: Sequence, annotation_size: int):
        """(order, batches): the dense family's bucket batches of a
        request, and the request index of each graph in their order."""
        # A request-local adapter carries this request's annotation
        # width: the shared one must not change under a concurrent
        # request of another width.
        adapter = make_adapter(self.variant, self.config, DatasetMeta(
            max_num_vertices=self.meta.max_num_vertices,
            num_edge_types=self.meta.num_edge_types,
            annotation_size=annotation_size), drop_remainder=False)
        processed = adapter.preprocess(list(raw_graphs), False)
        # Bucketing re-orders graphs; each keeps its request index (the
        # native packer's buckets hold the indices themselves).
        if isinstance(processed, native_pack.DenseProcessed):
            order = [int(i) for ids in processed.bucket_order for i in ids]
        else:
            order = [int(g["graph_id"]) for bucket in processed.values()
                     for g in bucket]
        dtype = self._dense_adjacency_dtype()
        # The predictor's adjacency dtype, whichever packer ran: an
        # artifact's dispatch must not depend on this host's packer.
        return order, (
            dataclasses.replace(b, adjacency=_with_dtype(b.adjacency, dtype))
            for b in adapter.batches(processed, False))

    def _call_dense(self, raw_graphs: Sequence,
                    annotation_size: int) -> np.ndarray:
        if len(raw_graphs) == 1:
            batch = self._pack_single_dense(raw_graphs[0], annotation_size)
            return self._forward(batch)[:, :1]
        order, batches = self._dense_batches(raw_graphs, annotation_size)
        outs = [self._forward(batch)[:, :int(batch.num_graphs)]
                for batch in batches]
        packed = np.concatenate(outs, axis=1)
        result = np.empty_like(packed)
        result[:, np.asarray(order)] = packed
        return result
