"""Writes the Orbax fixture of the port's tests with the JAX package's
own `save_checkpoint`: a directory checkpoint and its pickle twin of a
seeded 1-epoch `sparse` Runner at hidden 32, two layers (weights and
Adam state).

    JAX_PLATFORMS=cpu python tests/fixtures/orbax/write_fixture.py

writes `tests/fixtures/orbax/sparse_h32` and `sparse_h32.pickle`
(replacing them). The port reads both with no orbax, tensorstore or
zstandard (tests/test_torch_orbax.py, chip_smoke.py phase 22).
"""

import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from ggnn_tpu.data.synthetic import synthetic_molecules  # noqa: E402
from ggnn_tpu.training.checkpoint import save_checkpoint  # noqa: E402
from ggnn_tpu.training.config import default_params_for  # noqa: E402
from ggnn_tpu.training.runner import Runner  # noqa: E402

NAME = "sparse_h32"
# Two layers, so the pair stays under 1 MB.
CONFIG = {"hidden_size": 32, "layer_timesteps": [2, 1],
          "residual_connections": {"1": [0]}, "num_epochs": 1,
          "random_seed": 0, "batch_size": 600}


def main():
    config = default_params_for("sparse")
    config.update(CONFIG)
    with tempfile.TemporaryDirectory() as log_dir:
        runner = Runner("sparse", config, log_dir=log_dir, quiet=True,
                        train_data=synthetic_molecules(40, seed=0),
                        valid_data=synthetic_molecules(20, seed=1))
        runner.train()
    path = os.path.join(HERE, NAME)
    if os.path.exists(path):
        shutil.rmtree(path)
    for target in (path, path + ".pickle"):
        save_checkpoint(target, runner.config, runner.state,
                        runner.train_step_id, runner.valid_step_id)


if __name__ == "__main__":
    main()
