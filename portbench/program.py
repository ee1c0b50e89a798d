"""The system under test: the entries of `ggnn_tpu_torch` the windows
drive, built from the benchmark's molecules and weights. The only module
of the benchmark that imports the port."""

from typing import Dict, List

import torch

from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training.config import default_params_for
from ggnn_tpu_torch.training.runner import Runner
from ggnn_tpu_torch.training.variants import make_adapter
from ggnn_tpu_torch.utils.timing import graph_key


def port_config(config: Dict, random_seed: int) -> Dict:
    """The port's configuration: its variant's defaults, the
    configuration file's `model` keys over them, the run's seed."""
    params = default_params_for(config["variant"])
    params.update(config["model"])
    params["random_seed"] = int(random_seed)
    return params


@torch.no_grad()
def load_weights(params: torch.nn.Module,
                 weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the port's parameters by name;
    every parameter must get one."""
    own = dict(params.named_parameters())
    if set(own) != set(weights):
        raise ValueError(f"weights {sorted(set(weights) ^ set(own))} "
                         "do not match the port's parameters")
    for name, value in weights.items():
        own[name].copy_(value)


def runner(config: Dict, random_seed: int, train: List[Dict],
           valid: List[Dict], weights: Dict[str, torch.Tensor],
           log_dir: str, device) -> Runner:
    """The port's training Runner over the molecules, quiet, with no
    summaries, holding the benchmark's weights."""
    run = Runner(config["variant"], port_config(config, random_seed),
                 train_data=train, valid_data=valid, log_dir=log_dir,
                 quiet=True, tensorboard=False, device=device)
    load_weights(run.params, weights)
    return run


def predictor(config: Dict, weights: Dict[str, torch.Tensor],
              max_nodes: int, max_graphs: int, device) -> Predictor:
    """The port's Predictor at the envelope, holding the benchmark's
    weights."""
    params = port_config(config, 0)
    meta = DatasetMeta(max_num_vertices=max_nodes,
                       num_edge_types=config["edge_types"],
                       annotation_size=config["annotation_size"])
    gen = torch.Generator().manual_seed(0)
    model = ModelParams(
        make_adapter(config["variant"], params, meta).build_model(gen),
        init_output_heads(gen, params["hidden_size"], params["task_ids"]))
    load_weights(model, weights)
    return Predictor(config["variant"], params, meta, model,
                     max_nodes=max_nodes, max_graphs=max_graphs,
                     device=device)


def capture_all(run: Runner, batches) -> None:
    """Capture the train step's graph of every batch shape not yet
    captured, on the card, with the step's state restored after (no
    update is made); a no-op on the CPU, where steps run eagerly."""
    if run.device.type != "cuda":
        return
    new = {}
    for batch in batches:
        key = graph_key(batch)
        if key not in run.train_graphs.graphs:
            new.setdefault(key, batch)
    if new:
        run.train_graphs.capture(new)


def adam_first_moments(run: Runner) -> Dict[str, torch.Tensor]:
    """Adam's first moments by parameter name (a copy)."""
    return {n: m.detach().clone() for n, m in run.optimizer.mu.items()}


def parameters(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters by name (a copy)."""
    return {n: p.detach().clone() for n, p in params.named_parameters()}
