"""Command-line entry point of the port: train a sparse GGNN.

    python -m ggnn_tpu_torch.cli sparse|rgcn [--config-file FILE]
        [--config JSON] [--log_dir DIR] [--data_dir DIR] [--restore FILE]
        [--freeze-graph-model] [--restrict_data N] [--synthetic N]
        [--quiet] [--save-every-epoch] [--pdb] [--device DEVICE]

The flags of `ggnn_tpu/cli.py` for these variants, plus `--device`: the
run goes to the GPU unless `--device cpu` is given, and exits non-zero
without CUDA. `--synthetic N` trains on N synthetic QM9-shaped
molecules (and validates on N // 10) instead of JSON files.

The other variants and the flags of the JAX CLI that are not ported yet
are accepted and exit non-zero naming the ROADMAP item that ports them.
"""

import argparse
import sys
import traceback

_VARIANTS_NOT_PORTED = {"dense": "A6", "blocked": "A6", "gcn": "A7",
                        "gcn_blocked": "A7", "async": "A8"}
# flag destination -> (flag, ROADMAP item)
_FLAGS_NOT_PORTED = {
    "evaluate": ("--evaluate", "A9"),
    "profile": ("--profile", "A9"),
    "checkpoint_every_steps": ("--checkpoint-every-steps", "A9"),
    "export_artifact": ("--export-artifact", "A10"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ggnn_tpu_torch",
        description="GGNN training on an NVIDIA GPU (PyTorch port)")
    p.add_argument("variant",
                   choices=["sparse", "rgcn", *_VARIANTS_NOT_PORTED])
    p.add_argument("--config-file", dest="config_file", default=None,
                   help="Hyperparameter configuration file path (JSON).")
    p.add_argument("--config", default=None,
                   help="Hyperparameter configuration dictionary (JSON).")
    p.add_argument("--log_dir", default=".", help="Log dir name.")
    p.add_argument("--data_dir", default="", help="Data dir name.")
    p.add_argument("--restore", default=None,
                   help="File to restore weights from.")
    p.add_argument("--freeze-graph-model", action="store_true",
                   help="Freeze weights of graph model components.")
    p.add_argument("--restrict_data", type=int, default=None,
                   help="Use only the first N graphs of each file.")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="Train on N synthetic QM9-shaped molecules instead "
                        "of JSON files.")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--save-every-epoch", action="store_true",
                   help="Also write a rolling <run_id>_model_last.pickle "
                        "after every epoch.")
    p.add_argument("--pdb", action="store_true",
                   help="Drop into pdb.post_mortem on any exception.")
    p.add_argument("--device", default=None,
                   help="Device to run on (default: the GPU; 'cpu' for "
                        "the CPU).")
    p.add_argument("--evaluate", action="store_true",
                   help="Not ported yet (ROADMAP A9).")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Not ported yet (ROADMAP A9).")
    p.add_argument("--checkpoint-every-steps", type=int, default=0,
                   metavar="K", help="Not ported yet (ROADMAP A9).")
    p.add_argument("--export-artifact", default=None, metavar="PATH",
                   help="Not ported yet (ROADMAP A10).")
    return p


def _not_ported(args) -> str:
    """The message for a variant or flag that is not ported, or ''."""
    if args.variant in _VARIANTS_NOT_PORTED:
        return (f"variant '{args.variant}' is not ported yet (ROADMAP "
                f"{_VARIANTS_NOT_PORTED[args.variant]})")
    for dest, (flag, item) in _FLAGS_NOT_PORTED.items():
        if getattr(args, dest):
            return f"{flag} is not ported yet (ROADMAP {item})"
    return ""


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    message = _not_ported(args)
    if message:
        print(message, file=sys.stderr)
        return 2
    # Everything from config parsing onward sits inside the try: --pdb
    # promises post-mortem on any exception.
    try:
        from ggnn_tpu_torch.training.config import resolve_config
        from ggnn_tpu_torch.training.runner import Runner

        config = resolve_config(args.variant, args.config_file, args.config)
        train_data = valid_data = None
        if args.synthetic is not None:
            from ggnn_tpu_torch.data.synthetic import synthetic_molecules
            if not config["task_ids"]:
                raise ValueError("config task_ids must be non-empty")
            # As many target columns as the task ids index.
            n_targets = max(config["task_ids"]) + 1
            n = args.synthetic
            train_data = synthetic_molecules(
                n, seed=config["random_seed"], num_targets=n_targets)
            valid_data = synthetic_molecules(
                max(1, n // 10), seed=config["random_seed"] + 1,
                num_targets=n_targets)
        runner = Runner(
            args.variant, config, data_dir=args.data_dir,
            log_dir=args.log_dir, restore=args.restore,
            freeze_graph_model=args.freeze_graph_model,
            train_data=train_data, valid_data=valid_data,
            restrict_data=args.restrict_data, quiet=args.quiet,
            save_every_epoch=args.save_every_epoch, device=args.device)
        runner.train()
        return 0
    except Exception:
        traceback.print_exc()
        if args.pdb:
            import pdb
            pdb.post_mortem()
        return 1


if __name__ == "__main__":
    sys.exit(main())
