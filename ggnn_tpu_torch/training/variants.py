"""Per-variant adapters: model construction, preprocessing and packing
behind one interface, so the Runner (training/runner.py) is
model-agnostic. The port of `ggnn_tpu/training/variants.py`: the sparse
adapter (variants `sparse` and `rgcn`), the dense one (`dense` and
`blocked`), the GCN one (`gcn`), the dense GCN one (`gcn_blocked`) and
the async one (`async`).

As in JAX, every adapter but `async` packs through the native C++
packer (data/native_pack.py over ggnn_tpu_torch/native) when the config's
`native_pack` is true (the default) and the library builds, and through
the numpy packers (data/packing.py) otherwise or under
GGNN_TPU_NO_NATIVE=1; under `compute_dtype: bfloat16` the native dense
batches carry a bf16 adjacency, as JAX's do. `async` packs with
data/async_schedule.py, through a corpus-level `AsyncPackCache` unless
`async_pack_cache` is false. Every batch equals the JAX package's batch
of the same config bit for bit.
"""

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ggnn_tpu_torch.data import async_schedule, native_pack, packing
from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.models.async_ggnn import AsyncGGNN
from ggnn_tpu_torch.models.dense_ggnn import DenseGGNN
from ggnn_tpu_torch.models.gcn import GCN, BlockedGCN
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.native import native_available


def _use_native(config: Dict) -> bool:
    """The native C++ batch assembly (data/native_pack.py): on by default
    when the library builds; `"native_pack": false` (or
    GGNN_TPU_NO_NATIVE=1) selects the numpy packers."""
    return bool(config.get("native_pack", True)) and native_available()


def _dense_adjacency_dtype(config: Dict):
    """The native dense batches' adjacency dtype: bf16 under
    `compute_dtype: bfloat16` (0/1 entries, exact), else f32."""
    if config.get("compute_dtype", "float32") == "bfloat16":
        return torch.bfloat16
    return np.float32


def _nonempty(p) -> bool:
    if isinstance(p, (list, tuple, dict)):
        return len(p) > 0
    return p is not None


def _merged_caps(caps) -> packing.PackCapacities:
    """The field-wise largest of the splits' planned capacities."""
    if not caps:
        raise ValueError(
            "every data split is empty — nothing to plan capacities "
            "over (check the data files / --restrict_data / "
            "task_sample_ratios)")
    return packing.PackCapacities(
        nodes=max(c.nodes for c in caps),
        edges_per_type=max(c.edges_per_type for c in caps),
        graphs=max(c.graphs for c in caps),
        edges_all=max(c.edges_all for c in caps),
    )


class SparseAdapter:
    name = "sparse"

    def __init__(self, config: Dict, meta: DatasetMeta):
        self.config = config
        self.meta = meta
        self.caps = None

    def build_model(self, generator: torch.Generator,
                    edge_axis=None) -> SparseGGNN:
        return SparseGGNN(self.config, self.meta.num_edge_types, generator,
                          edge_axis=edge_axis)

    def preprocess(self, raw, is_training: bool,
                   rng: Optional[np.random.RandomState] = None):
        if _use_native(self.config):
            return native_pack.preprocess_sparse_native(
                raw, self.meta.num_edge_types, self.config["tie_fwd_bkwd"],
                self.config["task_ids"], self.config["task_sample_ratios"],
                is_training, rng)
        return packing.preprocess_sparse(
            raw, self.meta.num_edge_types, self.config["tie_fwd_bkwd"],
            self.config["task_ids"], self.config["task_sample_ratios"],
            is_training, rng)

    def plan(self, *processed_lists) -> packing.PackCapacities:
        margin = self.config.get("pack_margin")
        # Merge every field across splits: dropping edges_all would
        # disable the type-combined lane the model needs.
        self.caps = _merged_caps([
            native_pack.plan_capacities_native(
                p, self.config["batch_size"], margin=margin)
            if isinstance(p, native_pack.SparseProcessed)
            else packing.plan_capacities(p, self.meta.num_edge_types,
                                         self.config["batch_size"],
                                         margin=margin)
            for p in processed_lists if _nonempty(p)])
        return self.caps

    def batches(self, processed, is_training: bool,
                rng: Optional[np.random.RandomState] = None) -> Iterator:
        if isinstance(processed, native_pack.SparseProcessed):
            return native_pack.pack_sparse_batches_native(
                processed, self.meta.num_edge_types,
                self.config["tie_fwd_bkwd"], self.config["batch_size"],
                self.caps, self.config["hidden_size"],
                self.meta.annotation_size, is_training, rng)
        return packing.pack_sparse_batches(
            processed, self.meta.num_edge_types, self.config["batch_size"],
            self.caps, self.config["hidden_size"], self.meta.annotation_size,
            is_training, rng)


class DenseAdapter:
    """`dense` and `blocked`: bucketed dense batches of `batch_size`
    graphs, shapes from the bucket table (no capacity plan)."""
    name = "dense"

    def __init__(self, config: Dict, meta: DatasetMeta,
                 drop_remainder: Optional[bool] = None):
        self.config = config
        self.meta = meta
        # The reference drops each bucket's remainder graphs
        # (chem_tensorflow_dense.py:160); the config key turns that off,
        # and the argument (serving) wins over both.
        if drop_remainder is None:
            drop_remainder = bool(config.get("drop_remainder", True))
        self.drop_remainder = drop_remainder
        self.bucket_sizes = None

    def build_model(self, generator: torch.Generator) -> DenseGGNN:
        return DenseGGNN(self.config, self.meta.num_edge_types, generator)

    def _bucket_sizes(self) -> Optional[np.ndarray]:
        """`dense_bucket_sizes` overrides the reference bucket table:
        the same numbers (padding is masked and disconnected), fewer
        shapes."""
        sizes = self.config.get("dense_bucket_sizes")
        return None if sizes is None else np.asarray(sizes)

    def preprocess(self, raw, is_training: bool,
                   rng: Optional[np.random.RandomState] = None):
        if _use_native(self.config):
            return native_pack.preprocess_dense_native(
                raw, self.config["task_ids"],
                self.config["task_sample_ratios"], is_training, rng,
                bucket_sizes=self._bucket_sizes(),
                num_edge_types=self.meta.num_edge_types,
                tie_fwd_bkwd=self.config["tie_fwd_bkwd"])
        bucketed, self.bucket_sizes = packing.preprocess_dense(
            raw, self.meta.num_edge_types, self.config["tie_fwd_bkwd"],
            self.config["task_ids"], self.config["task_sample_ratios"],
            is_training, rng, bucket_sizes=self._bucket_sizes())
        return bucketed

    def plan(self, *processed_lists) -> None:
        return None  # dense shapes come from the bucket table

    def batches(self, processed, is_training: bool,
                rng: Optional[np.random.RandomState] = None) -> Iterator:
        if isinstance(processed, native_pack.DenseProcessed):
            return native_pack.pack_dense_batches_native(
                processed, self.config["batch_size"],
                self.config["hidden_size"], self.meta.annotation_size,
                self.meta.num_edge_types, self.config["tie_fwd_bkwd"],
                is_training, rng, drop_remainder=self.drop_remainder,
                adjacency_dtype=_dense_adjacency_dtype(self.config))
        return packing.pack_dense_batches(
            processed, self.bucket_sizes, self.config["batch_size"],
            self.config["hidden_size"], self.meta.annotation_size,
            is_training, rng, drop_remainder=self.drop_remainder)


class GCNAdapter:
    """`gcn`: normalised COO lists packed under the sparse node budget,
    capacities planned over every split."""
    name = "gcn"

    def __init__(self, config: Dict, meta: DatasetMeta):
        self.config = config
        self.meta = meta
        self.caps = None

    def build_model(self, generator: torch.Generator,
                    edge_axis=None) -> GCN:
        return GCN(self.config, generator, edge_axis=edge_axis)

    def preprocess(self, raw, is_training: bool,
                   rng: Optional[np.random.RandomState] = None):
        if _use_native(self.config):
            return native_pack.preprocess_gcn_native(
                raw, self.config["task_ids"],
                self.config["task_sample_ratios"], is_training, rng)
        return packing.preprocess_gcn(
            raw, self.config["task_ids"], self.config["task_sample_ratios"],
            is_training, rng)

    def plan(self, *processed_lists) -> packing.PackCapacities:
        margin = self.config.get("pack_margin")
        self.caps = _merged_caps([
            native_pack.plan_gcn_capacities_native(
                p, self.config["batch_size"], margin=margin)
            if isinstance(p, native_pack.GCNProcessed)
            else packing.plan_gcn_capacities(p, self.config["batch_size"],
                                             margin=margin)
            for p in processed_lists if _nonempty(p)])
        return self.caps

    def batches(self, processed, is_training: bool,
                rng: Optional[np.random.RandomState] = None) -> Iterator:
        if isinstance(processed, native_pack.GCNProcessed):
            return native_pack.pack_gcn_batches_native(
                processed, self.config["batch_size"], self.caps,
                self.config["hidden_size"], self.meta.annotation_size,
                is_training, rng)
        return packing.pack_gcn_batches(
            processed, self.config["batch_size"], self.caps,
            self.config["hidden_size"], self.meta.annotation_size,
            is_training, rng)


class GcnBlockedAdapter(DenseAdapter):
    """`gcn_blocked`: GCN math on the bucketed dense path. The dense
    adapter's batching, with the normalised [1, V, V] adjacency of
    `preprocess_gcn_dense` and `BlockedGCN`. Drops no bucket remainder
    unless the config's `drop_remainder` says so."""
    name = "gcn_blocked"

    def __init__(self, config: Dict, meta: DatasetMeta,
                 drop_remainder: Optional[bool] = None):
        if drop_remainder is None:
            drop_remainder = bool(config.get("drop_remainder", False))
        super().__init__(config, meta, drop_remainder)

    def build_model(self, generator: torch.Generator) -> BlockedGCN:
        return BlockedGCN(self.config, generator)

    def preprocess(self, raw, is_training: bool,
                   rng: Optional[np.random.RandomState] = None):
        if _use_native(self.config):
            return native_pack.preprocess_gcn_dense_native(
                raw, self.config["task_ids"],
                self.config["task_sample_ratios"], is_training, rng,
                bucket_sizes=self._bucket_sizes())
        bucketed, self.bucket_sizes = packing.preprocess_gcn_dense(
            raw, self.config["task_ids"], self.config["task_sample_ratios"],
            is_training, rng, bucket_sizes=self._bucket_sizes())
        return bucketed

    def batches(self, processed, is_training: bool,
                rng: Optional[np.random.RandomState] = None) -> Iterator:
        """The normalised [B, 1, V, V] batches (f32 under any
        compute_dtype, as in JAX: the model casts)."""
        if isinstance(processed, native_pack.DenseProcessed):
            return native_pack.pack_gcn_dense_batches_native(
                processed, self.config["batch_size"],
                self.config["hidden_size"], self.meta.annotation_size,
                is_training, rng, drop_remainder=self.drop_remainder)
        return super().batches(processed, is_training, rng)


class AsyncAdapter:
    """`async`: DFS schedules packed under the `num_nodes` budget, one
    capacity and segment plan over every split."""
    name = "async"
    # The corpora kept in each cache; a Runner holds two (training and
    # validation).
    _CACHE_CAP = 4

    def __init__(self, config: Dict, meta: DatasetMeta):
        self.config = config
        self.meta = meta
        self.caps = None
        # id(processed) -> (processed, its AsyncPackCache), and for
        # async_epoch_shuffle "batches" -> (processed, its packed
        # batches); first in first out, holding `processed` keeps its id
        # valid.
        self._pack_caches: Dict[int, Any] = {}
        self._batch_caches: Dict[int, Any] = {}

    def _cache_put(self, caches: Dict[int, Any], key: int, value) -> None:
        while len(caches) >= self._CACHE_CAP:
            caches.pop(next(iter(caches)))
        caches[key] = value

    def build_model(self, generator: torch.Generator) -> AsyncGGNN:
        return AsyncGGNN(self.config, self.meta.num_edge_types, generator)

    def preprocess(self, raw, is_training: bool,
                   rng: Optional[np.random.RandomState] = None):
        return async_schedule.preprocess_async(
            raw, self.meta.num_edge_types, self.config["tie_fwd_bkwd"],
            self.config["propagation_rounds"],
            self.config["propagation_substeps"],
            self.config["task_ids"], self.config["task_sample_ratios"],
            is_training, rng)

    def plan(self, *processed_lists) -> async_schedule.AsyncCapacities:
        # One plan over every split, the segment plan included: training
        # and validation batches get the same shapes.
        self.caps = async_schedule.plan_async_capacities_multi(
            [p for p in processed_lists if p],
            self.meta.num_edge_types, self.config["num_nodes"],
            self.config["propagation_rounds"],
            margin=self.config.get("pack_margin"))
        return self.caps

    def _pack_cache(self, processed):
        """The corpus's `AsyncPackCache` (data/async_schedule.py), built
        on first use; `"async_pack_cache": false` opts out (a corpus
        mutated between epochs)."""
        if not self.config.get("async_pack_cache", True):
            return None
        entry = self._pack_caches.get(id(processed))
        if entry is not None and entry[0] is processed:
            return entry[1]
        cache = async_schedule.build_async_pack_cache(
            processed, self.config["propagation_rounds"],
            self.config["propagation_substeps"], self.meta.num_edge_types)
        self._cache_put(self._pack_caches, id(processed),
                        (processed, cache))
        return cache

    def _pack(self, processed, is_training: bool, rng):
        return async_schedule.pack_async_batches(
            processed, self.meta.num_edge_types, self.config["num_nodes"],
            self.caps, self.config["propagation_rounds"],
            self.config["propagation_substeps"], self.config["hidden_size"],
            self.meta.annotation_size, is_training, rng,
            cache=self._pack_cache(processed))

    def batches(self, processed, is_training: bool,
                rng: Optional[np.random.RandomState] = None) -> Iterator:
        """`async_epoch_shuffle: "graphs"` (the default, the reference's
        chem_tensorflow_async.py:341) packs every epoch after a graph
        shuffle; `"batches"` (configs/async_tpu.json) packs a corpus once,
        in its preprocessed order, and shuffles the batch order each
        training epoch, holding every packed batch."""
        mode = self.config.get("async_epoch_shuffle", "graphs")
        if mode not in ("graphs", "batches"):
            raise ValueError(
                f"async_epoch_shuffle must be 'graphs' or 'batches', "
                f"got {mode!r}")
        if mode == "graphs":
            return self._pack(processed, is_training, rng)
        entry = self._batch_caches.get(id(processed))
        if entry is None or entry[0] is not processed:
            entry = (processed, list(self._pack(processed, False, None)))
            self._cache_put(self._batch_caches, id(processed), entry)
        packed = entry[1]
        if is_training and rng is not None:
            return (packed[i] for i in rng.permutation(len(packed)))
        return iter(packed)


def make_adapter(variant: str, config: Dict, meta: DatasetMeta,
                 drop_remainder: Optional[bool] = None):
    """The adapter of a variant. `drop_remainder` (dense family only)
    overrides the config; by default `dense` keeps the reference's
    remainder dropping and `blocked` and `gcn_blocked` process every
    graph, and the config key `drop_remainder` wins in each."""
    if variant in ("sparse", "rgcn"):
        return SparseAdapter(config, meta)
    if variant in ("dense", "blocked"):
        if variant == "blocked" and drop_remainder is None:
            drop_remainder = bool(config.get("drop_remainder", False))
        return DenseAdapter(config, meta, drop_remainder)
    if variant == "gcn":
        return GCNAdapter(config, meta)
    if variant == "gcn_blocked":
        return GcnBlockedAdapter(config, meta, drop_remainder)
    if variant == "async":
        return AsyncAdapter(config, meta)
    raise ValueError(f"unknown model variant '{variant}'")
