"""Corpus loading, metadata inference, packing and QM9 ingestion; the
re-exports of `ggnn_tpu/data/__init__.py`."""

from ggnn_tpu_torch.data.loader import (DatasetMeta, infer_metadata,
                                        load_graphs_json)
from ggnn_tpu_torch.data.packing import (DENSE_BUCKET_SIZES, PackCapacities,
                                         pack_dense_batches,
                                         pack_sparse_batches,
                                         plan_capacities, preprocess_dense,
                                         preprocess_sparse)
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
