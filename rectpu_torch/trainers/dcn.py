"""DCN-v2 trainer CLI: the port of ``rectpu/trainers/dcn.py``.

The flags are rectpu's (the zoo's common and deep flags, --num-cross-layers,
--cross-rank, --optimizer, --learning-rate, --numeric-columns) plus
``--device``:

    python -m rectpu_torch.trainers.dcn --preset scaled --embedding-size 64 \\
        --hidden-units 256 128 --num-cross-layers 2 --batch-size 4096 \\
        --train-steps 100 --job-dir <dir>

trains on the card (``--device cpu`` runs the plain PyTorch versions of the
kernels) and writes checkpoints and exports in rectpu's layout.
"""

from __future__ import annotations

from argparse import ArgumentParser

from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.models import DCNModel, TowerConfig
from rectpu_torch.trainers.common import add_common_args, add_deep_args, apply_preset, run
from rectpu_torch.train.optimizers import get_optimizer


def build_model(args) -> DCNModel:
    cfg = TowerConfig(
        feature_set=ml_100k_feature_set(numeric=tuple(args.numeric_columns or ())),
        embedding_size=args.embedding_size,
        hidden_units=tuple(args.hidden_units),
        dropout=args.dropout,
        dropout_impl=args.dropout_impl,
        embedding_impl=args.embedding_impl,
        compute_dtype=args.compute_dtype,
        table_grad_dtype=args.table_grad_dtype,
        table_dtype=args.table_dtype,
        flat_layout=args.flat_layout,
        scatter_impl=args.scatter_impl,
        table_padding=2048 if args.scatter_impl in ("mxu", "auto") else 128,
    )
    return DCNModel(cfg, num_cross_layers=args.num_cross_layers, low_rank=args.cross_rank)


def train_and_evaluate(args):
    """Train and evaluate from parsed args; returns (final metrics, trainer)."""
    args = apply_preset(args)
    return run(args, build_model(args), get_optimizer(args.optimizer, args.learning_rate))


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    add_common_args(parser, job_dir_default="checkpoints/dcn")
    add_deep_args(parser)
    parser.add_argument("--num-cross-layers", type=int, default=3,
                        help="explicit feature-cross layers (default: %(default)s)")
    parser.add_argument("--cross-rank", type=int, default=None,
                        help="low-rank factorization of the cross weights "
                             "(W = U V^T, O(D r) per layer instead of O(D^2))")
    parser.add_argument("--optimizer", default="Adam",
                        choices=["Adagrad", "Adam", "Ftrl", "RMSProp", "SGD"],
                        help="optimizer (default: %(default)s)")
    parser.add_argument("--learning-rate", type=float, default=0.001,
                        help="learning rate (default: %(default)s)")
    parser.add_argument("--numeric-columns", nargs="*", default=[],
                        help="numeric feature columns fed via the value*vector embedding "
                             "trick")
    return parser


if __name__ == "__main__":
    train_and_evaluate(build_parser().parse_args())
