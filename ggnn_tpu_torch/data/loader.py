"""Corpus metadata inference.

The graph schema is the reference's (get_data.py:75-89): a list of
  {"targets": [[float], ...], "graph": [[src, type, dst], ...],
   "node_features": [[...one-hot...], ...]}
with 1-based edge types. Inference reproduces chem_tensorflow.py:104-123:
the max vertex id, `num_edge_types` as the max forward type (doubled when
forward/backward weights are untied), and `annotation_size` as the
node-feature width of the first graph, accumulated across datasets.
"""

import dataclasses
import json
from typing import Any, List, Optional, Sequence


@dataclasses.dataclass
class DatasetMeta:
    max_num_vertices: int = 0
    num_edge_types: int = 0
    annotation_size: int = 0

    def update_from(self, data: Sequence[Any],
                    tie_fwd_bkwd: bool) -> "DatasetMeta":
        if not data:
            raise ValueError("cannot infer metadata from an empty dataset")
        num_fwd_edge_types = 0
        for g in data:
            # default=: edgeless graphs (single-atom molecules) are valid.
            self.max_num_vertices = max(
                self.max_num_vertices,
                max((v for e in g["graph"] for v in (e[0], e[2])),
                    default=0),
            )
            num_fwd_edge_types = max(
                num_fwd_edge_types,
                max((e[1] for e in g["graph"]), default=0))
        self.num_edge_types = max(
            self.num_edge_types,
            num_fwd_edge_types * (1 if tie_fwd_bkwd else 2),
        )
        first_feats = data[0]["node_features"]
        if not first_feats:
            raise ValueError(
                "cannot infer annotation_size: the first graph has no "
                "node_features rows")
        self.annotation_size = max(self.annotation_size,
                                   len(first_feats[0]))
        return self


def infer_metadata(datasets: Sequence[Sequence[Any]],
                   tie_fwd_bkwd: bool) -> DatasetMeta:
    meta = DatasetMeta()
    for data in datasets:
        meta.update_from(data, tie_fwd_bkwd)
    return meta


def graph_string_to_array(graph_string: str) -> List[List[int]]:
    """A whitespace graph string, one "src type dst" edge a line, as
    [[src, type, dst], ...] (an unused helper of the reference,
    chem_tensorflow.py:125-128)."""
    return [[int(v) for v in s.split(" ")]
            for s in graph_string.split("\n")]


def load_graphs_json(path: str, restrict: Optional[int] = None) -> List[Any]:
    """A JSON corpus file; `restrict` keeps its first N graphs."""
    with open(path, "r") as f:
        data = json.load(f)
    if restrict is not None and restrict > 0:
        data = data[:restrict]
    return data
