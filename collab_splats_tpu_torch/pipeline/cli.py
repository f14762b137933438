"""Pipeline CLI: the ``run_pipeline.py`` front end.

Counterpart of the JAX package's ``pipeline/cli.py``, with the same parser,
stages and return codes: run the full pipeline for a dataset config
(``--dataset`` with ``--config-dir``, which needs PyYAML) with dot-notation
overrides (``--set k=v``), or directly on an input path (``--input`` with
``--method``).  ``--device cpu`` runs it without a card.

    collab-splats-tpu-torch --input scene_dir --method rade-gs
    python -m collab_splats_tpu_torch.pipeline.cli --config-dir configs --dataset ants --set training.max_iterations=1000
"""

from __future__ import annotations

import argparse
import sys

from .config import parse_cli_overrides
from .splatter import Splatter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="collab-splats-tpu pipeline "
                                "(PyTorch + CUDA)")
    p.add_argument("--dataset", help="dataset config name (datasets/<name>.yaml)")
    p.add_argument("--config-dir", help="directory with base.yaml + datasets/")
    p.add_argument("--input", help="input path (video / images / dataset dir)")
    p.add_argument("--method", default="rade-gs",
                   help="splatting method (see --list-methods)")
    p.add_argument("--output", help="output directory")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dot-notation config override (repeatable)")
    p.add_argument("--overwrite", action="store_true",
                   help="rerun stages even if outputs exist")
    p.add_argument("--list-datasets", action="store_true")
    p.add_argument("--list-methods", action="store_true")
    p.add_argument("--stage", choices=["all", "preprocess", "train", "mesh"],
                   default="all")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_methods:
        Splatter.available_methods()
        return 0
    if args.list_datasets:
        if not args.config_dir:
            print("--list-datasets requires --config-dir", file=sys.stderr)
            return 2
        from .config import ConfigLoader

        for name in ConfigLoader(args.config_dir).list_datasets():
            print(name)
        return 0

    overrides = parse_cli_overrides(args.set)
    if args.config_dir:
        splatter = Splatter.from_config_file(
            args.dataset, args.config_dir, overrides, device=args.device)
    elif args.input:
        cfg = {"file_path": args.input, "method": args.method}
        if args.output:
            cfg["output_path"] = args.output
        cfg.update({k: v for k, v in overrides.items()
                    if not isinstance(v, dict)})
        splatter = Splatter(cfg, device=args.device)
        splatter._preprocess_config = overrides.get("preprocess", {})
        splatter._training_config = overrides.get("training", {})
        splatter._meshing_config = overrides.get("meshing", {})
    else:
        print("Provide --config-dir/--dataset or --input", file=sys.stderr)
        return 2

    if args.stage == "all":
        splatter.run_pipeline(overwrite=args.overwrite)
    elif args.stage == "preprocess":
        splatter.preprocess(overwrite=args.overwrite,
                            **splatter._preprocess_config)
    elif args.stage == "train":
        splatter.preprocess(overwrite=False, **splatter._preprocess_config)
        splatter.train(overwrite=args.overwrite, **splatter._training_config)
    elif args.stage == "mesh":
        splatter.mesh(overwrite=args.overwrite,
                      **dict(splatter._meshing_config))
    return 0


if __name__ == "__main__":
    sys.exit(main())
