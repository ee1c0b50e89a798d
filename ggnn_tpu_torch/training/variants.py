"""Per-variant adapters: model construction, preprocessing and packing
behind one interface, so the Runner (training/runner.py) is
model-agnostic. The port of `ggnn_tpu/training/variants.py`: the sparse
adapter (variants `sparse` and `rgcn`), the dense one (`dense` and
`blocked`), the GCN one (`gcn`), the dense GCN one (`gcn_blocked`) and
the async one (`async`).

The adapters pack with the port's numpy packers (data/packing.py,
data/async_schedule.py), whose batches are bit-identical to the JAX
package's numpy packers. A config's `native_pack` and `async_pack_cache`
keys are accepted and do not change that: the native C++ packer and the
async corpus cache are not ported yet (ROADMAP A12).
"""

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ggnn_tpu_torch.data import async_schedule, packing
from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.models.async_ggnn import AsyncGGNN
from ggnn_tpu_torch.models.dense_ggnn import DenseGGNN
from ggnn_tpu_torch.models.gcn import GCN, BlockedGCN
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN


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

    def build_model(self, generator: torch.Generator) -> SparseGGNN:
        return SparseGGNN(self.config, self.meta.num_edge_types, generator)

    def preprocess(self, raw, is_training: bool,
                   rng: Optional[np.random.RandomState] = None):
        return packing.preprocess_sparse(
            raw, self.meta.num_edge_types, self.config["tie_fwd_bkwd"],
            self.config["task_ids"], self.config["task_sample_ratios"],
            is_training, rng)

    def plan(self, *processed_lists) -> packing.PackCapacities:
        margin = self.config.get("pack_margin")
        # Merge every field across splits: dropping edges_all would
        # disable the type-combined lane the model needs.
        self.caps = _merged_caps([
            packing.plan_capacities(p, self.meta.num_edge_types,
                                    self.config["batch_size"], margin=margin)
            for p in processed_lists if _nonempty(p)])
        return self.caps

    def batches(self, processed, is_training: bool,
                rng: Optional[np.random.RandomState] = None) -> Iterator:
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
        bucketed, self.bucket_sizes = packing.preprocess_dense(
            raw, self.meta.num_edge_types, self.config["tie_fwd_bkwd"],
            self.config["task_ids"], self.config["task_sample_ratios"],
            is_training, rng, bucket_sizes=self._bucket_sizes())
        return bucketed

    def plan(self, *processed_lists) -> None:
        return None  # dense shapes come from the bucket table

    def batches(self, processed, is_training: bool,
                rng: Optional[np.random.RandomState] = None) -> Iterator:
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

    def build_model(self, generator: torch.Generator) -> GCN:
        return GCN(self.config, generator)

    def preprocess(self, raw, is_training: bool,
                   rng: Optional[np.random.RandomState] = None):
        return packing.preprocess_gcn(
            raw, self.config["task_ids"], self.config["task_sample_ratios"],
            is_training, rng)

    def plan(self, *processed_lists) -> packing.PackCapacities:
        margin = self.config.get("pack_margin")
        self.caps = _merged_caps([
            packing.plan_gcn_capacities(p, self.config["batch_size"],
                                        margin=margin)
            for p in processed_lists if _nonempty(p)])
        return self.caps

    def batches(self, processed, is_training: bool,
                rng: Optional[np.random.RandomState] = None) -> Iterator:
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
        bucketed, self.bucket_sizes = packing.preprocess_gcn_dense(
            raw, self.config["task_ids"], self.config["task_sample_ratios"],
            is_training, rng, bucket_sizes=self._bucket_sizes())
        return bucketed


class AsyncAdapter:
    """`async`: DFS schedules packed under the `num_nodes` budget, one
    capacity and segment plan over every split."""
    name = "async"
    # The packed corpora kept for async_epoch_shuffle "batches"; a
    # Runner holds two (training and validation).
    _CACHE_CAP = 4

    def __init__(self, config: Dict, meta: DatasetMeta):
        self.config = config
        self.meta = meta
        self.caps = None
        # id(processed) -> (processed, its packed batches), first in
        # first out; holding `processed` keeps its id valid.
        self._batch_caches: Dict[int, Any] = {}

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

    def _pack(self, processed, is_training: bool, rng):
        return async_schedule.pack_async_batches(
            processed, self.meta.num_edge_types, self.config["num_nodes"],
            self.caps, self.config["propagation_rounds"],
            self.config["propagation_substeps"], self.config["hidden_size"],
            self.meta.annotation_size, is_training, rng)

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
            while len(self._batch_caches) >= self._CACHE_CAP:
                self._batch_caches.pop(next(iter(self._batch_caches)))
            self._batch_caches[id(processed)] = entry
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
