"""Command-line entry point of the port: train a GGNN.

    python -m ggnn_tpu_torch.cli sparse|rgcn|dense|blocked|gcn|gcn_blocked|async
        [--config-file FILE] [--config JSON] [--log_dir DIR]
        [--data_dir DIR] [--restore FILE] [--freeze-graph-model] [--restrict_data N] [--synthetic N]
        [--quiet] [--save-every-epoch] [--checkpoint-every-steps K]
        [--evaluate] [--profile DIR] [--pdb] [--device DEVICE]
        [--export-artifact PATH [--export-max-nodes N] [--export-max-graphs N]]

The flags of `ggnn_tpu/cli.py` for these variants, plus `--device`: the
run goes to the GPU unless `--device cpu` is given, and exits non-zero
without CUDA. `--synthetic N` trains on N synthetic QM9-shaped
molecules (and validates on N // 10) instead of JSON files (`python -m
ggnn_tpu_torch.data.qm9` writes QM9's). `--restore` takes a pickle of
either package or a reference TF1 pickle; a rolling checkpoint of
`--checkpoint-every-steps` resumes the interrupted epoch at the batch it
stopped at. `--evaluate` prints the targets and predictions of the
first 10 validation molecules instead of training. `--profile DIR`
writes a `torch.profiler` Chrome trace of epoch 1's training epoch.
`--export-artifact PATH` with `--restore` writes a `.ggnnx` deployment
artifact (export.py) instead of training; `--config` and `--config-file`
then apply as overrides on the checkpoint's config. Serve it with
`python -m ggnn_tpu_torch.server --checkpoint PATH`.
"""

import argparse
import sys
import traceback


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ggnn_tpu_torch",
        description="GGNN training on an NVIDIA GPU (PyTorch port)")
    p.add_argument("variant",
                   choices=["sparse", "rgcn", "dense", "blocked", "gcn",
                            "gcn_blocked", "async"])
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
                   help="Example evaluation using a restored model.")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Write a torch.profiler Chrome trace of the first "
                        "training epoch to DIR.")
    p.add_argument("--checkpoint-every-steps", type=int, default=0,
                   metavar="K",
                   help="Mid-epoch preemption recovery: every K training "
                        "steps, write the rolling checkpoint with the "
                        "data-iterator state (epoch, stream position, "
                        "RNG), so --restore resumes the same epoch at the "
                        "same batch.")
    p.add_argument("--export-artifact", default=None, metavar="PATH",
                   help="With --restore: write a .ggnnx deployment "
                        "artifact (torch.export programs + weights; see "
                        "ggnn_tpu_torch/export.py) instead of training. "
                        "Serve it with `python -m ggnn_tpu_torch.server "
                        "--checkpoint PATH`.")
    p.add_argument("--export-max-nodes", type=int, default=2048,
                   help="Serving envelope for --export-artifact "
                        "(edge-list/async variants).")
    p.add_argument("--export-max-graphs", type=int, default=256,
                   help="Serving envelope for --export-artifact.")
    return p


def _export(args) -> None:
    """--export-artifact: the restored checkpoint served by a Predictor,
    written as an artifact; --config and --config-file override the
    checkpoint's config on the serving surface."""
    import json
    import os

    from ggnn_tpu_torch.export import export_predictor
    from ggnn_tpu_torch.serving import Predictor

    overrides = {}
    if args.config_file is not None:
        with open(args.config_file) as f:
            overrides.update(json.load(f))
    if args.config is not None:
        overrides.update(json.loads(args.config))
    predictor = Predictor.from_checkpoint(
        args.restore, args.variant, max_nodes=args.export_max_nodes,
        max_graphs=args.export_max_graphs,
        config_overrides=overrides or None, device=args.device)
    out = export_predictor(predictor, args.export_artifact)
    if not args.quiet:
        print(f"wrote {out} ({os.path.getsize(out)} bytes, "
              "platforms cpu+cuda)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.export_artifact is not None and args.restore is None:
        print("--export-artifact requires --restore CHECKPOINT",
              file=sys.stderr)
        return 2
    # Everything from config parsing onward sits inside the try: --pdb
    # promises post-mortem on any exception.
    try:
        if args.export_artifact is not None:
            _export(args)
            return 0
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
            profile_dir=args.profile,
            save_every_epoch=args.save_every_epoch,
            checkpoint_every_steps=args.checkpoint_every_steps,
            device=args.device)
        if args.evaluate:
            # Without --synthetic, the config's valid_file in --data_dir.
            runner.example_evaluation(
                example_molecules=None if valid_data is None
                else valid_data[:10])
        else:
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
