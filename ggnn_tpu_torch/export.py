"""Deployment artifacts: Predictor -> `torch.export` programs + weights,
the port of `ggnn_tpu/export.py`.

  * `export_predictor(predictor, path)` writes one `.ggnnx` zip: one
    `torch.export` program per packed batch shape (the envelope's for
    the edge-list and async variants, one per bucket for the dense
    family), the weights, and the packing metadata needed to serve;
  * `load_predictor(path)` returns an `ExportedPredictor`: the
    Predictor's host pipeline (packing, micro-batching, request
    validation) in front of the pinned programs, so later edits to
    `ggnn_tpu_torch/models` cannot change what a deployed artifact
    computes (tests/test_torch_export.py sabotages the live model after
    export to show it). On the card each program is replayed as a CUDA
    graph, as JAX jits each exported call.

A program is traced on the CPU, under `torch.no_grad()`, from
`serving.serve_forward` with the parameters as inputs, so it holds no
weight. The kernels of ops/kernels/ are `torch.library` ops
(`torch.ops.ggnn_tpu_torch.*`): a program records each kernel call as
the op and, loaded on the GPU, launches the hand-written kernel (on the
CPU, its plain version). Factory calls that the trace fixed to the CPU
(`arange`, `zeros`) are moved to the serving device at load
(`torch.export.passes.move_to_device_pass`), so an artifact exported on
a CPU-only host serves on the card.

Format (`.ggnnx` = zip):
    meta.json     format_version ("torch-1"), runtime ("torch"),
                  variant, config, dataset meta, envelope, platforms,
                  torch_version, and each program's batch signature,
                  batch fields and file
    params.npz    the weights, each entry named by its JSON-encoded
                  path in the JAX package's params pytree (dict keys,
                  list indices), so loading never unpickles
                  (np.load runs with allow_pickle=False)
    fn_<i>.pt2    `torch.export.save` of one program

The JAX package writes the same zip layout with `jax.export` programs
(format_version 2, no runtime marker): each package's loader refuses the
other's artifact with a ValueError naming the loader to use.
"""

import dataclasses
import io
import json
import zipfile
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.export.passes
from torch import nn

from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.graph import _SCALARS
from ggnn_tpu_torch.serving import _DENSE_FAMILY, Predictor, serve_forward
from ggnn_tpu_torch.training.checkpoint import (params_from_jax_weights,
                                                params_tree,
                                                weights_from_tree)
from ggnn_tpu_torch.utils.device import resolve_device

FORMAT_VERSION = "torch-1"
RUNTIME = "torch"


def _flatten_params(params) -> Dict[str, np.ndarray]:
    """Nested dict/list pytree of arrays -> {json-path: array}, the codec
    of `ggnn_tpu/export.py:_flatten_params`: a (key|index)* path is a
    complete address of a tree of str-keyed dicts and lists."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, value in node.items():
                # A non-str key would round-trip to a string: a silent
                # change of the tree's structure.
                if not isinstance(key, str):
                    raise TypeError(
                        f"non-string dict key {key!r} at {path}: .ggnnx "
                        "param paths require str dict keys")
                walk(value, path + [key])
        elif isinstance(node, list):
            for i, value in enumerate(node):
                walk(value, path + [i])
        elif isinstance(node, tuple):
            # It would reload as a list.
            raise TypeError(f"tuple params container at {path}: .ggnnx "
                            "stores dict/list pytrees only")
        else:
            out[json.dumps(path)] = np.asarray(node)

    walk(params, [])
    return out


def _unflatten_params(flat: Dict[str, np.ndarray]):
    """Inverse of `_flatten_params`. Integer path components rebuild
    lists (indices are asserted dense), strings rebuild dicts."""
    root: Dict = {}
    for key in sorted(flat):
        parts = json.loads(key)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]

    def materialize(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            idxs = sorted(node)
            if idxs != list(range(len(idxs))):
                raise ValueError(f"non-dense list indices {idxs} in params")
            return [materialize(node[i]) for i in idxs]
        if any(isinstance(k, int) for k in node):
            raise ValueError("mixed int/str keys in params path")
        return {k: materialize(v) for k, v in node.items()}

    return materialize(root)


def _leaf_fields(batch) -> Tuple[str, ...]:
    """The fields of a packed batch that a program takes: its arrays; the
    scalars (python ints once on a device) and the absent fields stay
    out, and the traced batch holds None there."""
    fields = []
    for field in dataclasses.fields(batch):
        value = getattr(batch, field.name)
        if field.name in _SCALARS or value is None:
            continue
        if isinstance(value, tuple) or dataclasses.is_dataclass(value):
            raise ValueError(
                f"batch field '{field.name}' is nested: an artifact serves "
                "flat batches only (the async serving path has no plan)")
        fields.append(field.name)
    return tuple(fields)


def _dtype_name(value) -> str:
    """A leaf's dtype as the signature names it: numpy's name ("float32",
    "int32"), and for a torch leaf (the native packer's bf16 adjacency;
    numpy has no bf16) torch's without its prefix ("bfloat16")."""
    if isinstance(value, torch.Tensor):
        return str(value.dtype).replace("torch.", "")
    return str(np.asarray(value).dtype)


def _batch_signature(batch) -> Tuple:
    """Hashable (shape, dtype) over the batch's program inputs: the
    dispatch key between packed batches and programs."""
    return tuple((tuple(np.shape(getattr(batch, f))),
                  _dtype_name(getattr(batch, f)))
                 for f in _leaf_fields(batch))


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def _sig_to_json(sig: Tuple) -> List:
    return [[list(shape), dtype] for shape, dtype in sig]


def _sig_from_json(data: List) -> Tuple:
    return tuple((tuple(shape), dtype) for shape, dtype in data)


class _Forward(nn.Module):
    """`serve_forward` as a module over the predictor's `graph` and
    `heads` (the names of `ModelParams`)."""

    def __init__(self, params: nn.Module, task_ids: Sequence[int]):
        super().__init__()
        self.graph = params.graph
        self.heads = params.heads
        self.task_ids = list(task_ids)

    def forward(self, batch) -> torch.Tensor:
        return serve_forward(self, self.task_ids, batch)


class _Served(nn.Module):
    """The served function of one packed batch layout, (params, batch
    leaves) -> predictions [K, G]: `serve_forward` with the parameters
    swapped in from the inputs. The model is kept in a tuple, not as a
    submodule, so that an exported program holds none of its weights."""

    def __init__(self, params: nn.Module, task_ids: Sequence[int],
                 batch_type, fields: Tuple[str, ...]):
        super().__init__()
        self._model = (_Forward(params, task_ids),)
        self.batch_type = batch_type
        self.fields = fields

    def forward(self, params: Dict[str, torch.Tensor],
                leaves: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        absent = {f.name: None for f in dataclasses.fields(self.batch_type)
                  if f.name not in self.fields}
        batch = self.batch_type(**dict(zip(self.fields, leaves)), **absent)
        return torch.func.functional_call(self._model[0], params, (batch,),
                                          strict=True)


def _example_batches(predictor: Predictor) -> List:
    """One packed batch per shape the predictor can produce: the
    envelope's for the edge-list and async variants, one per bucket for
    the dense family (the bucket table is the shape set)."""
    ann = 1  # packed feature rows are padded to hidden: width-independent
    graphs = predictor.example_graphs(ann)
    if predictor.variant in _DENSE_FAMILY:
        # `_dense_batches` packs with a request-local adapter: the live
        # one keeps its annotation width.
        return list(predictor._dense_batches(graphs, ann)[1])
    return list(predictor._batches(graphs, ann))


def _cpu_params(predictor: Predictor) -> Dict[str, torch.Tensor]:
    return {name: p.detach().cpu()
            for name, p in sorted(predictor.params.named_parameters())}


def export_predictor(predictor: Predictor, path: str) -> str:
    """Write `predictor`'s device computation and weights to `path`:
    one program per batch shape, traced on the CPU, each serving on the
    CPU and on the GPU. Returns `path`."""
    params = _cpu_params(predictor)
    entries, blobs, seen = [], [], set()
    for batch in _example_batches(predictor):
        sig = _batch_signature(batch)
        if sig in seen:
            continue
        seen.add(sig)
        fields = _leaf_fields(batch)
        served = _Served(predictor.params, predictor.task_ids, type(batch),
                         fields)
        leaves = tuple(_as_tensor(getattr(batch, f)) for f in fields)
        with torch.no_grad():
            program = torch.export.export(served, (params, leaves),
                                          strict=False)
        blob = io.BytesIO()
        torch.export.save(program, blob)
        fname = f"fn_{len(blobs)}.pt2"
        entries.append({"sig": _sig_to_json(sig), "fields": list(fields),
                        "file": fname})
        blobs.append(blob.getvalue())
    meta = {
        "format_version": FORMAT_VERSION,
        "runtime": RUNTIME,
        "variant": predictor.variant,
        "config": predictor.config,
        "dataset_meta": dataclasses.asdict(predictor.meta),
        "max_nodes": predictor.max_nodes,
        "max_graphs": predictor.max_graphs,
        "platforms": ["cpu", "cuda"],
        "torch_version": torch.__version__,
        "functions": entries,
    }
    pbuf = io.BytesIO()
    np.savez(pbuf, **_flatten_params(params_tree(predictor.params)))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("params.npz", pbuf.getvalue())
        for entry, blob in zip(entries, blobs):
            z.writestr(entry["file"], blob)
    return path


class ExportedPredictor(Predictor):
    """A Predictor whose device math is the pinned programs of a
    `.ggnnx` artifact. Host-side behaviour (packing, validation,
    micro-batching, bucket scatter) is inherited; `_forward` dispatches
    each packed batch by its shape to its program. `self.model` stays
    None: artifact serving builds no model."""

    def __init__(self, variant: str, config: Dict, meta: DatasetMeta,
                 params: Dict[str, torch.Tensor], programs: Dict,
                 max_nodes: int, max_graphs: int, device=None):
        super().__init__(variant, config, meta, params, max_nodes=max_nodes,
                         max_graphs=max_graphs, device=device)
        self.model = None
        self._programs = {
            sig: (fields, torch.export.passes.move_to_device_pass(
                program, self.device).module())
            for sig, (fields, program) in programs.items()}

    def _place(self, params: Dict[str, torch.Tensor]):
        return {name: value.to(self.device)
                for name, value in sorted(params.items())}

    def _dense_adjacency_dtype(self):
        """The artifact's adjacency dtype, read from its programs'
        signatures (the adjacency is a dense batch's one 4-d leaf):
        whether this host has the native library must not change the
        dispatch key the artifact was exported with."""
        for sig in self._programs:
            for shape, dtype in sig:
                if len(shape) == 4:
                    return torch.bfloat16 if dtype == "bfloat16" \
                        else np.float32
        return super()._dense_adjacency_dtype()

    def _forward(self, batch) -> np.ndarray:
        sig = _batch_signature(batch)
        if sig not in self._programs:
            shapes = sorted(str([s for s, _ in k]) for k in self._programs)
            raise ValueError(
                "packed batch shape not present in the artifact "
                f"(got {[s for s, _ in sig]}; artifact has {shapes}). "
                "Re-export with an envelope/bucket table covering this "
                "request.")
        # One CUDA graph a program on the card, as JAX jits each
        # exported call; eager on the CPU.
        return super()._forward(batch)

    def _serve(self, batch) -> torch.Tensor:
        fields, program = self._programs[_batch_signature(batch)]
        leaves = tuple(getattr(batch, f) for f in fields)
        with torch.inference_mode():
            return program(self.params, leaves)


def load_predictor(path: str, device=None) -> ExportedPredictor:
    """Open a `.ggnnx` artifact written by `export_predictor`, serving on
    the GPU unless `device` names another (without CUDA it raises)."""
    device = resolve_device(device)
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("runtime") != RUNTIME:
            raise ValueError(
                f"'{path}' is not an artifact of ggnn_tpu_torch (format_"
                f"version {meta.get('format_version')!r}, no torch runtime "
                "marker): a JAX artifact (jax.export StableHLO) loads with "
                "ggnn_tpu.export.load_predictor")
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported artifact format_version "
                f"{meta.get('format_version')!r} (this build reads "
                f"{FORMAT_VERSION!r}); re-export the checkpoint with this "
                "build (`python -m ggnn_tpu_torch.cli VARIANT --restore "
                "CKPT --export-artifact PATH`)")
        with np.load(io.BytesIO(z.read("params.npz")),
                     allow_pickle=False) as npz:
            params = params_from_jax_weights(weights_from_tree(
                _unflatten_params({k: npz[k] for k in npz.files})))
        programs = {}
        for entry in meta["functions"]:
            program = torch.export.load(io.BytesIO(z.read(entry["file"])))
            programs[_sig_from_json(entry["sig"])] = (
                tuple(entry["fields"]), program)
    return ExportedPredictor(
        meta["variant"], meta["config"], DatasetMeta(**meta["dataset_meta"]),
        params, programs, meta["max_nodes"], meta["max_graphs"],
        device=device)
