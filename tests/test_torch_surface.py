"""The port's coverage of every public name of the JAX package.

Both packages are parsed with `ast`, and neither is imported (the test
needs no JAX). For every public top-level function, class and UPPER_CASE
constant of each `ggnn_tpu/<module>.py`, one of these holds:

  * `ggnn_tpu_torch/<module>.py` defines the same name;
  * `COUNTERPARTS` names the port's counterpart as "module.py:name",
    and that module defines that name;
  * `NO_COUNTERPART` gives the reason the name has none on a GPU.

No entry may say that a name is not ported, and no module of the port
may raise `NotImplementedError` naming a ROADMAP item.
"""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "ggnn_tpu")
PORT_PKG = os.path.join(ROOT, "ggnn_tpu_torch")

# JAX "module.py:name" -> the port's counterpart(s), "module.py:name".
COUNTERPARTS = {
    "models/base.py:get_activation": ["ops/cells.py:make_cell"],
    "models/dense_ggnn.py:flat_mask_cast": [
        "models/dense_ggnn.py:dense_attention"],
    "ops/cells.py:gru_init": ["ops/cells.py:GRUCell"],
    "ops/cells.py:gru_apply": ["ops/cells.py:GRUCell"],
    "ops/cells.py:cudnn_gru_init": ["ops/cells.py:CudnnCompatibleGRUCell"],
    "ops/cells.py:cudnn_gru_apply": ["ops/cells.py:CudnnCompatibleGRUCell"],
    "ops/cells.py:rnn_init": ["ops/cells.py:RNNCell"],
    "ops/cells.py:rnn_apply": ["ops/cells.py:RNNCell"],
    "ops/lanes.py:LANE": ["models/dense_ggnn.py:LANE"],
    "ops/lanes.py:resolve_lane_pad": ["models/dense_ggnn.py:resolve_lane_pad"],
    "ops/pallas/ell_spmm.py:ell_aggregate_by_type": [
        "ops/kernels/ell_spmm.py:ell_aggregate_by_type"],
    "ops/pallas/ell_spmm.py:ell_aggregate_by_type_reference": [
        "ops/kernels/ell_spmm.py:ell_aggregate_by_type_reference"],
    "ops/pallas/ell_spmm.py:ell_scatter_sum": [
        "ops/kernels/ell_spmm.py:ell_scatter_sum"],
    "ops/pallas/ell_spmm.py:ell_scatter_sum_reference": [
        "ops/kernels/ell_spmm.py:ell_scatter_sum_reference"],
    "parallel/mesh.py:process_aligned_data_rows": [
        "parallel/step.py:local_rows"],
    "parallel/stacking.py:stack_from_process_local": [
        "parallel/step.py:local_rows"],
    "training/optimizer.py:tf_adam": ["training/optimizer.py:TFAdam"],
    "training/optimizer.py:make_optimizer": ["training/optimizer.py:TFAdam"],
    "training/optimizer.py:clip_by_norm_per_leaf": [
        "training/optimizer.py:clip_by_norm"],
}

_LANE_PAD = ("pads H to the TPU's 128-lane tiles; the pad lanes stay zero "
             "(ggnn_tpu/ops/lanes.py:12-26), so the port computes at H and "
             "only validates `lane_pad`")
_SPECS = ("an XLA PartitionSpec tree for shard_map; each rank of the "
          "port's torch.distributed mesh holds its own leaves")

# JAX "module.py:name" -> why the port has no counterpart on a GPU.
NO_COUNTERPART = {
    "ops/lanes.py:round_up_lanes": _LANE_PAD,
    "ops/lanes.py:pad_last": _LANE_PAD,
    "ops/lanes.py:pad_row_blocks": _LANE_PAD,
    "ops/lanes.py:pad_col_groups": _LANE_PAD,
    "ops/lanes.py:pad_edge_weights_flat": _LANE_PAD,
    "ops/lanes.py:pad_cell_params": _LANE_PAD,
    "parallel/mesh.py:overlap_compiler_options": (
        "XLA:TPU's async-collective compiler flags; a torch.distributed "
        "collective runs when it is called"),
    "parallel/node_shard.py:sharded_batch_specs": _SPECS,
    "parallel/node_shard.py:gcn_sharded_batch_specs": _SPECS,
    "parallel/stacking.py:stacked_batch_specs": _SPECS,
    "parallel/stacking.py:stacked_dense_batch_specs": _SPECS,
    "parallel/stacking.py:data_parallel_specs": _SPECS,
    "parallel/tp.py:tp_batch_specs": _SPECS,
    "parallel/tp.py:tp_state_specs": _SPECS,
}

_CONSTANT = re.compile(r"[A-Z][A-Z0-9_]*")


def public_names(path):
    """The public top-level functions, classes and UPPER_CASE constants
    that the module at `path` defines (imports are not definitions)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name)
                         and _CONSTANT.fullmatch(n.id))
    return names


def _modules(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".py"))


def _port_defines(module, name):
    path = os.path.join(PORT_PKG, module)
    return os.path.exists(path) and name in public_names(path)


JAX_NAMES = sorted(f"{m}:{n}" for m in _modules(JAX_PKG)
                   for n in public_names(os.path.join(JAX_PKG, m)))


def test_the_jax_package_has_names_to_cover():
    assert len(JAX_NAMES) > 200
    assert "graph.py:ELLGraphBatch" in JAX_NAMES


def _uncovered(entry):
    """Why `entry` ("module.py:name") is not covered, or None."""
    module, name = entry.split(":")
    if _port_defines(module, name):
        if entry in COUNTERPARTS or entry in NO_COUNTERPART:
            return "defined in the port: drop its table entry"
        return None
    if entry in COUNTERPARTS:
        missing = [t for t in COUNTERPARTS[entry]
                   if not _port_defines(*t.split(":"))]
        return f"the port defines no {missing}" if missing else None
    if entry in NO_COUNTERPART:
        return None
    return (f"ggnn_tpu_torch/{module} defines no {name}, and the table "
            "gives no counterpart or reason")


def test_every_public_jax_name_has_a_counterpart():
    uncovered = {e: why for e in JAX_NAMES
                 if (why := _uncovered(e)) is not None}
    assert not uncovered


@pytest.mark.parametrize("table", ["COUNTERPARTS", "NO_COUNTERPART"])
def test_table_entries_name_jax_names_and_leave_none_unported(table):
    entries = globals()[table]
    for entry, value in entries.items():
        assert entry in JAX_NAMES, f"{entry} is no public name of ggnn_tpu"
        text = " ".join(value) if isinstance(value, list) else value
        assert text.strip()
        assert "not ported" not in text.lower(), entry
    assert not set(COUNTERPARTS) & set(NO_COUNTERPART)


def test_no_unported_roadmap_item_raises():
    pattern = re.compile(r"NotImplementedError\((?:[^()]|\([^()]*\))*"
                         r"ROADMAP", re.S)
    offenders = []
    for module in _modules(PORT_PKG):
        with open(os.path.join(PORT_PKG, module)) as f:
            text = f.read()
        if pattern.search(text) or re.search(r"not ported \(ROADMAP",
                                             text):
            offenders.append(module)
    assert not offenders
