"""AutoInt trainer CLI: the port of ``rectpu/trainers/autoint.py``.

The flags are rectpu's (the zoo's common and deep flags, --num-att-layers,
--num-heads, --head-dim, --att-impl, --att-group, --exclude-linear,
--packed-linear, --packed-col-pad, --optimizer, --learning-rate,
--numeric-columns) plus ``--device``:

    python -m rectpu_torch.trainers.autoint --preset scaled --embedding-size 64 \\
        --batch-size 4096 --train-steps 100 --job-dir <dir>

trains on the card (``--device cpu`` runs the plain PyTorch versions of the
kernels) and writes checkpoints and exports in rectpu's layout.
"""

from __future__ import annotations

from argparse import ArgumentParser

from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.models import AutoIntModel, TowerConfig
from rectpu_torch.models.autoint import ATT_IMPLS
from rectpu_torch.trainers.common import add_common_args, add_deep_args, apply_preset, run
from rectpu_torch.train.optimizers import get_optimizer


def build_model(args) -> AutoIntModel:
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
        packed_linear=args.flat_layout or args.packed_linear,
        packed_col_pad=args.packed_col_pad,
        scatter_impl=args.scatter_impl,
        table_padding=2048 if args.scatter_impl in ("mxu", "auto") else 128,
    )
    return AutoIntModel(cfg, use_linear=not args.exclude_linear,
                        num_layers=args.num_att_layers, num_heads=args.num_heads,
                        head_dim=args.head_dim, att_impl=args.att_impl,
                        att_group=args.att_group)


def train_and_evaluate(args):
    """Train and evaluate from parsed args; returns (final metrics, trainer)."""
    args = apply_preset(args)
    return run(args, build_model(args), get_optimizer(args.optimizer, args.learning_rate))


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    add_common_args(parser, job_dir_default="checkpoints/autoint")
    add_deep_args(parser)
    parser.add_argument("--num-att-layers", type=int, default=2,
                        help="interacting (self-attention) layers (default: %(default)s)")
    parser.add_argument("--num-heads", type=int, default=2,
                        help="attention heads (default: %(default)s)")
    parser.add_argument("--head-dim", type=int, default=None,
                        help="per-head dim (default: embedding_size/heads)")
    parser.add_argument("--att-impl", choices=list(ATT_IMPLS), default="broadcast",
                        help="rectpu's attention lowering: 'broadcast' and 'bf16' compute "
                             "one function in the port; 'grouped' packs --att-group "
                             "examples into one block-diagonal attention "
                             "(default: %(default)s)")
    parser.add_argument("--att-group", type=int, default=8,
                        help="examples packed per grouped-attention block "
                             "(default: %(default)s)")
    parser.add_argument("--exclude-linear", action="store_true",
                        help="drop the linear component")
    parser.add_argument("--packed-linear", action="store_true",
                        help="store the fused [V, K+1] table as one parameter")
    parser.add_argument("--packed-col-pad", type=int, default=0,
                        help="pad the packed table width to this multiple (default: "
                             "%(default)s)")
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
