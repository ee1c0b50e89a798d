"""Pickle checkpoints in the JAX package's format, and the weight bridge.

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
well as the weights; unused saved names are reported.

Not ported yet (ROADMAP A17): Orbax directory checkpoints and
reference-produced TF1 pickles.
"""

import os
import pickle
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

_KEY_PART = re.compile(r"\['([^']+)'\]|\[(\d+)\]")


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


def _restore_optimizer(optimizer, saved: Dict, log) -> set:
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
                value = saved.get(key)
                if value is None:
                    log(f"Freshly initializing {key} since no saved value "
                        "was found.")
                    continue
                if tuple(np.shape(value)) != tuple(tensor.shape):
                    raise ValueError(
                        f"checkpoint leaf '{key}' has shape "
                        f"{tuple(np.shape(value))} but the optimizer "
                        f"expects {tuple(tensor.shape)}")
                tensor.copy_(torch.from_numpy(np.array(value)))
                used.add(key)
    return used


def _is_pickle_path(path: str) -> bool:
    return path.endswith(".pickle") or path.endswith(".pkl")


def save_checkpoint(path: str, config: Dict, params: nn.Module,
                    train_step: int, valid_step: int,
                    optimizer=None) -> None:
    """The model's weights and, when given, the optimizer's state."""
    if not _is_pickle_path(path):
        raise NotImplementedError(
            f"'{path}' has no .pickle/.pkl extension, which selects the "
            "Orbax format; Orbax checkpoints are not ported yet "
            "(ROADMAP A17)")
    weights = jax_weights_from_params(params)
    if optimizer is not None:
        weights.update(optimizer_entries(optimizer))
    payload = {
        "params": config,
        "weights": weights,
        "train_step": train_step,
        "valid_step": valid_step,
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f, pickle.HIGHEST_PROTOCOL)


def _load_payload(path: str) -> Dict:
    if os.path.isdir(path) or (not os.path.exists(path)
                               and os.path.isdir(path + ".tmp_new")):
        raise NotImplementedError(
            f"'{path}' is an Orbax checkpoint directory; Orbax restore is "
            "not ported yet (ROADMAP A17)")
    with open(path, "rb") as f:
        return pickle.load(f)


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


def restore_checkpoint(path: str, config: Dict, params: nn.Module,
                       log=print, *, payload: Dict = None, optimizer=None
                       ) -> Tuple[nn.Module, int, int]:
    """Assign a checkpoint's weights to `params` in place, and its Adam
    state to `optimizer` when given. Returns (params, train_step,
    valid_step). `payload` skips the load when the caller already holds
    the loaded checkpoint."""
    if payload is None:
        payload = _load_payload(path)
    if _looks_tf1(payload):
        raise NotImplementedError(
            "TF1 reference checkpoints are not ported yet (ROADMAP A17)")
    _check_config(config, payload["params"])

    saved = payload["weights"]
    bridged = params_from_jax_weights(saved)
    own = dict(params.named_parameters())
    with torch.no_grad():
        for name, param in own.items():
            value = bridged.get(name)
            if value is None:
                log(f"Freshly initializing {_keystr(name)} since no saved "
                    "value was found.")
                continue
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
        used = _restore_optimizer(optimizer, saved, log)
    for key in saved:
        if _module_name(key) not in own and key not in used:
            log(f"Saved weights for {key} not used by model.")
    return params, payload["train_step"], payload["valid_step"]
