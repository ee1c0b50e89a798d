"""Checkpoints in the JAX package's two formats, and the weight bridge.

The payload is that of `ggnn_tpu/training/checkpoint.py` (after
chem_tensorflow.py:309-323): a pickle of
  {"params": <resolved config dict>,
   "weights": {JAX key path -> ndarray},
   "train_step": int, "valid_step": int}
where the key paths are `jax.tree_util.keystr` names of the JAX state
tree, e.g. "['params']['graph']['layers'][0]['cell']['gates_kernel']".
A checkpoint written by either package loads in the other.

The bridge is a rename: `ModelParams` (models/base.py) names its
parameters by the same path with dots ("graph.layers.0.cell.
gates_kernel"), and every parameter keeps the JAX layout, so no array is
transposed.

The Adam state of a training run (training/optimizer.py:TFAdam) is
saved under the JAX package's own key names, so either package resumes
the other's run with its moments:
  ['opt_state'][1]['count'], ['opt_state'][1]['mu']<param path>,
  ['opt_state'][1]['nu']<param path>
and, under --freeze-graph-model (heads only),
  ['opt_state'].inner_states['train'].inner_state[1][...].

Restore keeps the reference's semantics (chem_tensorflow.py:330-359):
the configs must match except `task_ids` and `num_epochs`; every saved
weight whose name matches is assigned (shape-checked); missing names keep
their fresh initialization and are reported, the optimizer's moments as
well as the weights; unused saved names are reported. A per-index leaf
(`...['edge_weights'][t]`, the async model's per-type weights) that an
older checkpoint stores as one stacked array under the base name takes
that array's row t, and rows past the model's leaves are reported, as
`ggnn_tpu/training/checkpoint.py` restores them.

A reference-produced TF1 pickle (chem_tensorflow.py:309-323, weights
keyed by TF variable name) restores through `compat/tf1.py`, as
`ggnn_tpu/training/checkpoint.py:225-245` restores it: the configs must
match on the keys both have, except `task_ids` and `num_epochs`; a task
head the pickle lacks keeps the fresh one; the optimizer's state stays
fresh (the reference's TF-Adam slots have no place in it).

A rolling checkpoint written mid-epoch (`Runner(checkpoint_every_steps=
K)`) also holds the data iterator's position, in the JAX package's
layout, so a run interrupted in one package resumes in the other:
  "iterator_state": {"epoch": int, "steps_done": int,
                     "np_rng_state": <numpy RandomState state as of the
                                      epoch's start>,
                     "torch_generator_state": <uint8 array>,
                     "torch_generator_device": "cuda" | "cpu"}
The last two are the port's dropout stream at the save point; the JAX
loader ignores them. The JAX package's `key` (its `jax.random` key at
the save point) is read and not used: the port's dropout stream is a
`torch.Generator`, not that key.

A path without a `.pickle`/`.pkl` extension selects the JAX package's
Orbax directory format (`ggnn_tpu/training/checkpoint.py:63-116`), read
and written by `training/orbax_dir.py` without orbax. The weights are
stored under `_sanitize`d names ("['params']['graph']['w']" ->
"params.graph.w"), a key collision refused; the config, the step
counters, `sanitized_keys: true` and the JSON-encoded iterator state go
to the `ggnn_meta.json` sidecar. A save stages `<path>.tmp_new` and swaps
it in through `<path>.tmp_old`, so a crash leaves the old checkpoint or
the complete new one, and `_load_payload` falls back to a complete
`.tmp_new`. Restore finds each leaf under its sanitized name, or under
the `_sanitize_legacy` name of older directories.
"""

import json
import os
import pickle
import re
import shutil
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

_KEY_PART = re.compile(r"\['([^']+)'\]|\[(\d+)\]")
_INDEXED_KEY = re.compile(r"(.+)\[(\d+)\]")
_SANITIZE_PART = re.compile(
    r"\['([^']+)'\]|\[(\d+)\]|\.([A-Za-z_][A-Za-z0-9_]*)")


def _sanitize(name: str) -> str:
    """JAX key path -> Orbax storage name, as the JAX package names it:
    "['a']['b'][0].c" -> "a.b.0.c" (dict, sequence and attribute
    segments)."""
    return ".".join(a or b or c for a, b, c in _SANITIZE_PART.findall(name))


def _sanitize_legacy(name: str) -> str:
    """The JAX package's older storage name, attribute segments dropped;
    restore looks a leaf up under it when its `_sanitize` name is
    absent."""
    return ".".join(a or b for a, b in _KEY_PART.findall(name))


def _keystr(name: str) -> str:
    """Module parameter name -> JAX key path of the same leaf."""
    parts = ["params"] + name.split(".")
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in parts)


def _module_name(key: str) -> Optional[str]:
    """JAX key path -> module parameter name, or None for a path outside
    ['params'] (or not a dict/sequence path at all)."""
    matches = list(_KEY_PART.finditer(key))
    if not matches or "".join(m.group(0) for m in matches) != key:
        return None
    parts = [m.group(1) or m.group(2) for m in matches]
    if parts[0] != "params" or len(parts) < 2:
        return None
    return ".".join(parts[1:])


def params_from_jax_weights(
        weights: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX-named weights -> {module parameter name: tensor}, ready for
    `ModelParams.load_state_dict`. Non-parameter entries are skipped."""
    out = {}
    for key, value in weights.items():
        name = _module_name(key)
        if name is not None:
            out[name] = torch.from_numpy(np.array(value))
    return out


def params_tree(module: nn.Module):
    """A module's parameters as the JAX package's params pytree: nested
    dicts (by name) and lists (by index) of numpy arrays."""
    root = {}
    for name, p in module.named_parameters():
        *parents, leaf = name.split(".")
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().cpu().numpy().copy()

    def materialize(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [materialize(node[str(i)]) for i in range(len(node))]
        return {k: materialize(v) for k, v in node.items()}

    return materialize(root)


def weights_from_tree(tree, prefix: str = "['params']"
                      ) -> Dict[str, np.ndarray]:
    """{JAX key path: ndarray} of a params pytree of nested dicts and
    lists, each path under `prefix`."""
    if isinstance(tree, dict):
        items = [(f"['{k}']", v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for part, value in items:
        out.update(weights_from_tree(value, prefix + part))
    return out


def jax_weights_from_params(params: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse bridge: {JAX key path: ndarray} of a module's
    parameters."""
    return {_keystr(name): p.detach().cpu().numpy().copy()
            for name, p in params.named_parameters()}


def _opt_prefix(optimizer) -> str:
    if optimizer.freeze_graph_model:
        return "['opt_state'].inner_states['train'].inner_state[1]"
    return "['opt_state'][1]"


def _moment_key(prefix: str, moment: str, name: str) -> str:
    """['opt_state'][1]['mu'] + the parameter's path below ['params']."""
    return f"{prefix}['{moment}']" + _keystr(name)[len("['params']"):]


def optimizer_entries(optimizer) -> Dict[str, np.ndarray]:
    """{JAX key path: ndarray} of a TFAdam's state."""
    prefix = _opt_prefix(optimizer)
    out = {f"{prefix}['count']": np.asarray(optimizer.count, np.int32)}
    for moment, state in (("mu", optimizer.mu), ("nu", optimizer.nu)):
        for name, value in state.items():
            out[_moment_key(prefix, moment, name)] = \
                value.detach().cpu().numpy().copy()
    return out


def _saved_value(saved: Dict, key: str, shape, split_rows: Dict, log):
    """The saved array of `key`; for a per-index leaf `base[i]` that the
    checkpoint stores stacked under `base` (rows of the leaf's shape),
    row i of it, with `split_rows[base]` the rows taken so far; else
    None."""
    if key in saved:
        return saved[key]
    match = _INDEXED_KEY.fullmatch(key)
    if match is None:
        return None
    base, idx = match.group(1), int(match.group(2))
    stacked = saved.get(base)
    if (stacked is None or np.ndim(stacked) != len(shape) + 1
            or idx >= np.shape(stacked)[0]
            or tuple(np.shape(stacked)[1:]) != tuple(shape)):
        return None
    if base not in split_rows:
        log(f"Splitting legacy stacked {base} across "
            f"{np.shape(stacked)[0]} per-index leaves.")
    split_rows[base] = max(split_rows.get(base, 0), idx + 1)
    return np.asarray(stacked)[idx]


def _restore_optimizer(optimizer, saved: Dict, log, split_rows: Dict) -> set:
    """Assign the saved Adam state found under the optimizer's key names;
    returns the keys used."""
    prefix = _opt_prefix(optimizer)
    used = set()
    count_key = f"{prefix}['count']"
    if count_key in saved:
        optimizer.count = int(np.asarray(saved[count_key]))
        used.add(count_key)
    else:
        log(f"Freshly initializing {count_key} since no saved value was "
            "found.")
    with torch.no_grad():
        for moment, state in (("mu", optimizer.mu), ("nu", optimizer.nu)):
            for name, tensor in state.items():
                key = _moment_key(prefix, moment, name)
                value = _saved_value(saved, key, tensor.shape, split_rows,
                                     log)
                if value is None:
                    log(f"Freshly initializing {key} since no saved value "
                        "was found.")
                    continue
                if tuple(np.shape(value)) != tuple(tensor.shape):
                    raise ValueError(
                        f"checkpoint leaf '{key}' has shape "
                        f"{tuple(np.shape(value))} but the optimizer "
                        f"expects {tuple(tensor.shape)}")
                tensor.copy_(_as_tensor(value))
                used.add(key)
    return used


def _is_pickle_path(path: str) -> bool:
    return path.endswith(".pickle") or path.endswith(".pkl")


def save_checkpoint(path: str, config: Dict, params: nn.Module,
                    train_step: int, valid_step: int,
                    optimizer=None, iterator_state: Dict = None) -> None:
    """The model's weights and, when given, the optimizer's state and the
    mid-epoch iterator state (see the module's docstring): a pickle at a
    `.pickle`/`.pkl` path, else an Orbax directory."""
    weights = jax_weights_from_params(params)
    if optimizer is not None:
        weights.update(optimizer_entries(optimizer))
    if not _is_pickle_path(path):
        _save_orbax(path, config, weights, train_step, valid_step,
                    iterator_state)
        return
    payload = {
        "params": config,
        "weights": weights,
        "train_step": train_step,
        "valid_step": valid_step,
    }
    if iterator_state is not None:
        payload["iterator_state"] = iterator_state
    with open(path, "wb") as f:
        pickle.dump(payload, f, pickle.HIGHEST_PROTOCOL)


def _save_orbax(path: str, config: Dict, weights: Dict[str, np.ndarray],
                train_step: int, valid_step: int,
                iterator_state: Optional[Dict]) -> None:
    """The directory checkpoint, staged and swapped in as the JAX
    package's `save_checkpoint` does."""
    from ggnn_tpu_torch.training import orbax_dir
    path = os.path.abspath(path)
    meta = {"params": config, "train_step": train_step,
            "valid_step": valid_step, "sanitized_keys": True}
    if iterator_state is not None:
        meta["iterator_state"] = _encode_iterator_state(iterator_state)
    sanitized = {}
    for key, value in weights.items():
        name = _sanitize(key)
        if name in sanitized:
            raise ValueError(
                f"checkpoint key collision: two leaves sanitize to "
                f"'{name}' — saving would silently drop one")
        sanitized[name] = value
    tmp = path + ".tmp_new"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    orbax_dir.write_arrays(tmp, sanitized)
    with open(os.path.join(tmp, "ggnn_meta.json"), "w") as f:
        json.dump(meta, f)
    # Two renames: a crash between them leaves the old checkpoint (at
    # .tmp_old) or the complete new one (at .tmp_new), never nothing.
    old = path + ".tmp_old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)


def _encode_iterator_state(it: Dict) -> Dict:
    """JSON-safe encoding (the form of the JAX package's Orbax meta
    sidecar): the arrays become lists."""
    out = dict(it)
    if "np_rng_state" in out:
        name, keys, pos, has_gauss, gauss = out["np_rng_state"]
        out["np_rng_state"] = [name, [int(k) for k in keys], int(pos),
                               int(has_gauss), float(gauss)]
    for key in ("key", "torch_generator_state"):
        if key in out:
            out[key] = [int(x) for x in np.asarray(out[key]).ravel()]
    return out


def _decode_iterator_state(it: Dict) -> Dict:
    """The inverse of `_encode_iterator_state`; a pickled state passes
    through unchanged."""
    out = dict(it)
    if "np_rng_state" in out and isinstance(out["np_rng_state"], list):
        name, keys, pos, has_gauss, gauss = out["np_rng_state"]
        out["np_rng_state"] = (name, np.asarray(keys, np.uint32), pos,
                               has_gauss, gauss)
    for key, dtype in (("key", np.uint32),
                       ("torch_generator_state", np.uint8)):
        if key in out and isinstance(out[key], list):
            out[key] = np.asarray(out[key], dtype)
    return out


def load_iterator_state(path: str):
    """The saved mid-epoch iterator state, or None. Of a directory, only
    the sidecar is read."""
    if os.path.isdir(path):
        with open(os.path.join(path, "ggnn_meta.json")) as f:
            it = json.load(f).get("iterator_state")
    else:
        it = _load_payload(path).get("iterator_state")
    return _decode_iterator_state(it) if it else None


def _load_payload(path: str) -> Dict:
    if not os.path.exists(path) and os.path.isdir(path + ".tmp_new"):
        # The crash window of a save: trust the staged directory only if
        # its sidecar, written last, is there and parses.
        staged_meta = os.path.join(path + ".tmp_new", "ggnn_meta.json")
        try:
            with open(staged_meta) as f:
                json.load(f)
            path = path + ".tmp_new"
        except (OSError, json.JSONDecodeError):
            raise FileNotFoundError(
                f"no checkpoint at '{path}'; an INCOMPLETE staged "
                f"checkpoint exists at '{path}.tmp_new' (crash during "
                "save) — delete it and restore an earlier checkpoint")
    if os.path.isdir(path):
        from ggnn_tpu_torch.training import orbax_dir
        with open(os.path.join(path, "ggnn_meta.json")) as f:
            meta = json.load(f)
        return {"params": meta["params"],
                "weights": orbax_dir.read_arrays(path),
                "train_step": meta["train_step"],
                "valid_step": meta["valid_step"],
                "iterator_state": meta.get("iterator_state"),
                "sanitized_keys": meta.get("sanitized_keys", False)}
    with open(path, "rb") as f:
        return pickle.load(f)


def _wanted_keys(params: nn.Module, optimizer) -> Iterable[str]:
    """Every JAX key path a restore looks up, the stacked base of each
    per-index key included."""
    keys = [_keystr(name) for name, _ in params.named_parameters()]
    if optimizer is not None:
        prefix = _opt_prefix(optimizer)
        keys.append(f"{prefix}['count']")
        for moment, state in (("mu", optimizer.mu), ("nu", optimizer.nu)):
            keys += [_moment_key(prefix, moment, name) for name in state]
    for key in list(keys):
        match = _INDEXED_KEY.fullmatch(key)
        if match is not None:
            keys.append(match.group(1))
    return keys


def _by_jax_key(saved: Dict, keys: Iterable[str]) -> Dict:
    """A directory's {sanitized name: array} re-keyed by the JAX key paths
    in `keys` (each found under its `_sanitize` name, else its
    `_sanitize_legacy` name); names no key claims keep their own."""
    out, taken = {}, set()
    for key in keys:
        for name in (_sanitize(key), _sanitize_legacy(key)):
            if name in saved:
                out[key] = saved[name]
                taken.add(name)
                break
    out.update((name, value) for name, value in saved.items()
               if name not in taken)
    return out


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.clone()
    return torch.from_numpy(np.array(value))


def _looks_tf1(payload: Dict) -> bool:
    """Reference-produced pickles key weights by TF variable name
    (scope paths with '/'); this format uses JAX key paths."""
    weights = payload.get("weights", {})
    return any("/" in str(k) for k in weights)


def _check_config(config: Dict, saved_config: Dict) -> None:
    # Explicit raises, not `assert` statements (python -O strips those);
    # AssertionError stays the TYPE, as in the reference
    # (chem_tensorflow.py:336).
    if len(config) != len(saved_config):
        extra = sorted(set(config) - set(saved_config))
        missing = sorted(set(saved_config) - set(config))
        raise AssertionError(
            "checkpoint config has a different key set "
            f"(only in current: {extra}; only in checkpoint: {missing})")
    for par, par_value in config.items():
        if par in ("task_ids", "num_epochs"):
            continue
        if par not in saved_config:
            raise AssertionError(
                f"config key '{par}' absent from the checkpoint "
                "(same size, different key set)")
        if par_value != saved_config[par]:
            raise AssertionError(
                f"config mismatch on '{par}': {par_value!r} != "
                f"{saved_config[par]!r}")


def _check_tf1_config(config: Dict, saved_config: Dict) -> None:
    """A TF1 pickle's config may be partial: only the keys it has must
    match, `task_ids` and `num_epochs` excepted."""
    for par, par_value in config.items():
        if par in ("task_ids", "num_epochs") or par not in saved_config:
            continue
        if par_value != saved_config[par]:
            raise AssertionError(
                f"config mismatch on '{par}': {par_value!r} != "
                f"{saved_config[par]!r}")


def _tf1_weights(payload: Dict, config: Dict, params: nn.Module, log,
                 variant: Optional[str],
                 num_edge_types: Optional[int]) -> Dict[str, np.ndarray]:
    """A TF1 pickle's weights converted to JAX key paths (`compat/
    tf1.py`); the skeleton's heads stand in for the tasks it lacks."""
    if variant is None or num_edge_types is None:
        raise ValueError(
            "TF1 reference checkpoint detected; restore it through "
            "Runner/Predictor (variant + metadata required)")
    from ggnn_tpu_torch.compat.tf1 import params_from_tf1_weights
    _check_tf1_config(config, payload["params"])
    tree = params_from_tf1_weights(
        variant, payload["weights"], config, num_edge_types,
        fallback_heads=params_tree(params.heads), log=log)
    return weights_from_tree(tree)


def restore_checkpoint(path: str, config: Dict, params: nn.Module,
                       log=print, *, payload: Dict = None, optimizer=None,
                       variant: Optional[str] = None,
                       num_edge_types: Optional[int] = None
                       ) -> Tuple[nn.Module, int, int]:
    """Assign a checkpoint's weights to `params` in place, and its Adam
    state to `optimizer` when given. Returns (params, train_step,
    valid_step). `payload` skips the load when the caller already holds
    the loaded checkpoint. A TF1 reference pickle needs the `variant`
    and the data's `num_edge_types`, and leaves `optimizer` fresh."""
    if payload is None:
        payload = _load_payload(path)
    tf1 = _looks_tf1(payload)
    if tf1:
        saved = _tf1_weights(payload, config, params, log, variant,
                             num_edge_types)
        optimizer = None
    else:
        _check_config(config, payload["params"])
        saved = payload["weights"]
        if payload.get("sanitized_keys"):
            saved = _by_jax_key(saved, _wanted_keys(params, optimizer))
    own = dict(params.named_parameters())
    split_rows = {}
    with torch.no_grad():
        for name, param in own.items():
            value = _saved_value(saved, _keystr(name), param.shape,
                                 split_rows, log)
            if value is None:
                log(f"Freshly initializing {_keystr(name)} since no saved "
                    "value was found.")
                continue
            value = _as_tensor(value)
            if tuple(value.shape) != tuple(param.shape):
                # Loudly, at restore time: geometry the config check
                # cannot see (num_edge_types comes from the data).
                raise ValueError(
                    f"checkpoint leaf '{_keystr(name)}' has shape "
                    f"{tuple(value.shape)} but the model expects "
                    f"{tuple(param.shape)} (e.g. a different "
                    "num_edge_types inferred from the dataset)")
            param.copy_(value)
    used = set()
    if optimizer is not None:
        used = _restore_optimizer(optimizer, saved, log, split_rows)
    for key in saved:
        if (_module_name(key) not in own and key not in used
                and key not in split_rows):
            log(f"Saved weights for {key} not used by model.")
    for base, rows in split_rows.items():
        surplus = np.shape(saved[base])[0] - rows
        if surplus > 0:
            # A stacked array with more rows than the model has leaves:
            # part of the checkpoint was not used.
            log(f"Saved stacked {base} has {surplus} surplus row(s) beyond "
                f"the model's {rows} per-index leaves; the extra rows were "
                "not used.")
    if tf1:
        log(f"Imported TF1 reference checkpoint {path}")
    return (params, payload.get("train_step", 0),
            payload.get("valid_step", 0))
