"""Per-variant adapters: model construction, preprocessing and packing
behind one interface, so the Runner (training/runner.py) is
model-agnostic. The port of `ggnn_tpu/training/variants.py`, with the
sparse adapter only (variants `sparse` and `rgcn`).

The adapter packs with the port's numpy packer (data/packing.py), whose
batches are bit-identical to the JAX package's numpy packer. A config's
`native_pack` key is accepted and does not change that: the native C++
packer is not ported yet (ROADMAP A12).
"""

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ggnn_tpu_torch.data import packing
from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.training.config import default_params_for


def _nonempty(p) -> bool:
    if isinstance(p, (list, tuple, dict)):
        return len(p) > 0
    return p is not None


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
        caps = [packing.plan_capacities(p, self.meta.num_edge_types,
                                        self.config["batch_size"],
                                        margin=margin)
                for p in processed_lists if _nonempty(p)]
        if not caps:
            raise ValueError(
                "every data split is empty — nothing to plan capacities "
                "over (check the data files / --restrict_data / "
                "task_sample_ratios)")
        # Merge every field across splits: dropping edges_all would
        # disable the type-combined lane the model needs.
        self.caps = packing.PackCapacities(
            nodes=max(c.nodes for c in caps),
            edges_per_type=max(c.edges_per_type for c in caps),
            graphs=max(c.graphs for c in caps),
            edges_all=max(c.edges_all for c in caps),
        )
        return self.caps

    def batches(self, processed, is_training: bool,
                rng: Optional[np.random.RandomState] = None) -> Iterator:
        return packing.pack_sparse_batches(
            processed, self.meta.num_edge_types, self.config["batch_size"],
            self.caps, self.config["hidden_size"], self.meta.annotation_size,
            is_training, rng)


def make_adapter(variant: str, config: Dict, meta: DatasetMeta):
    if variant in ("sparse", "rgcn"):
        return SparseAdapter(config, meta)
    # Raises NotImplementedError naming the ROADMAP item (A6, A7, A8) of
    # a known variant, ValueError for an unknown one.
    default_params_for(variant)
    raise ValueError(f"unknown model variant '{variant}'")
