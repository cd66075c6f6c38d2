"""DLRM trainer CLI: the port of ``rectpu/trainers/dlrm.py``.

The flags are rectpu's (``trainers/dlrm.py:46-73``: the zoo's common and deep
flags, --bot-hidden-units, --arch-interaction-itself, --interaction-impl,
--optimizer, --learning-rate, --numeric-columns) plus ``--device``:

    python -m rectpu_torch.trainers.dlrm --preset scaled --embedding-size 64 \\
        --hidden-units 256 128 --batch-size 4096 --train-steps 100 --job-dir <dir>

trains on the card (``--device cpu`` runs the plain PyTorch versions of the
kernels) and writes checkpoints and exports in rectpu's layout. As in rectpu,
the optimizer has fp32 slots (this CLI has no --optimizer-slot-dtype).
"""

from __future__ import annotations

from argparse import ArgumentParser

from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.models import DLRMModel, TowerConfig
from rectpu_torch.ops.interaction import IMPLS
from rectpu_torch.trainers.common import add_common_args, add_deep_args, apply_preset, run
from rectpu_torch.train.optimizers import get_optimizer


def build_model(args) -> DLRMModel:
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
    return DLRMModel(cfg, bot_hidden_units=tuple(args.bot_hidden_units),
                     arch_interaction_itself=args.arch_interaction_itself,
                     interaction_impl=args.interaction_impl)


def train_and_evaluate(args):
    """Train and evaluate from parsed args; returns (final metrics, trainer)."""
    args = apply_preset(args)
    model = build_model(args)
    return run(args, model, get_optimizer(args.optimizer, args.learning_rate))


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    add_common_args(parser, job_dir_default="checkpoints/dlrm")
    add_deep_args(parser)
    parser.add_argument("--bot-hidden-units", type=int, nargs="+", default=[64],
                        help="bottom-MLP hidden layers mapping dense features into the "
                             "embedding space (default: %(default)s)")
    parser.add_argument("--arch-interaction-itself", action="store_true",
                        help="include self-interactions (the diagonal) in the pairwise-dot "
                             "block")
    parser.add_argument("--interaction-impl", default="auto", choices=list(IMPLS),
                        help="pairwise-dot implementation (ops/interaction.py), all "
                             "on the one kernel: auto and pallas-mxu round each product "
                             "to the input type in the flat form; pallas, xla and "
                             "xla-autodiff take exact products (default: %(default)s)")
    parser.add_argument("--optimizer", default="Adam",
                        choices=["Adagrad", "Adam", "Ftrl", "RMSProp", "SGD"],
                        help="optimizer (default: %(default)s; only Adam is ported)")
    parser.add_argument("--learning-rate", type=float, default=0.001,
                        help="learning rate (default: %(default)s)")
    parser.add_argument("--numeric-columns", nargs="*", default=[],
                        help="numeric feature columns fed to the bottom MLP")
    return parser


if __name__ == "__main__":
    train_and_evaluate(build_parser().parse_args())
