"""xDeepFM trainer CLI: the port of ``rectpu/trainers/xdeep_fm.py``.

The flags are rectpu's (``trainers/xdeep_fm.py:49-81``: the zoo's common and
deep flags, --cin-units, --cin-layout, the --exclude-* toggles,
--packed-linear, --packed-col-pad, --optimizer, --learning-rate,
--numeric-columns) plus ``--device``:

    python -m rectpu_torch.trainers.xdeep_fm --preset scaled --embedding-size 64 \\
        --hidden-units 256 128 --batch-size 4096 --train-steps 100 --job-dir <dir>

trains on the card (``--device cpu`` runs the plain PyTorch versions of the
kernels) and writes checkpoints and exports in rectpu's layout. As in rectpu,
the optimizer has fp32 slots (this CLI has no --optimizer-slot-dtype).
"""

from __future__ import annotations

from argparse import ArgumentParser

from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.models import TowerConfig, XDeepFMModel
from rectpu_torch.trainers.common import add_common_args, add_deep_args, apply_preset, run
from rectpu_torch.train.optimizers import get_optimizer


def build_model(args) -> XDeepFMModel:
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
    return XDeepFMModel(cfg, use_linear=not args.exclude_linear, use_cin=not args.exclude_cin,
                        use_dnn=not args.exclude_dnn, cin_units=tuple(args.cin_units),
                        cin_layout=args.cin_layout)


def train_and_evaluate(args):
    """Train and evaluate from parsed args; returns (final metrics, trainer)."""
    args = apply_preset(args)
    model = build_model(args)
    return run(args, model, get_optimizer(args.optimizer, args.learning_rate))


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    add_common_args(parser, job_dir_default="checkpoints/xdeep_fm")
    add_deep_args(parser)
    parser.add_argument("--cin-units", nargs="+", type=int, default=[64, 64],
                        help="CIN layer widths (default: %(default)s)")
    parser.add_argument("--cin-layout", choices=["legacy", "kmajor"], default="legacy",
                        help="CIN operand layout: [B, *, K] or K-major [B, K, *]; the same "
                             "kernels take either (default: %(default)s)")
    parser.add_argument("--exclude-linear", action="store_true",
                        help="drop the linear component")
    parser.add_argument("--exclude-cin", action="store_true", help="drop the CIN component")
    parser.add_argument("--exclude-dnn", action="store_true", help="drop the DNN component")
    parser.add_argument("--packed-linear", action="store_true",
                        help="store the fused [V, K+1] table as one parameter")
    parser.add_argument("--packed-col-pad", type=int, default=0,
                        help="pad the packed table width to this multiple (default: "
                             "%(default)s)")
    parser.add_argument("--optimizer", default="Adam",
                        choices=["Adagrad", "Adam", "Ftrl", "RMSProp", "SGD"],
                        help="optimizer (default: %(default)s; only Adam is ported)")
    parser.add_argument("--learning-rate", type=float, default=0.001,
                        help="learning rate (default: %(default)s)")
    parser.add_argument("--numeric-columns", nargs="*", default=[],
                        help="numeric feature columns fed via the value*vector embedding "
                             "trick")
    return parser


if __name__ == "__main__":
    train_and_evaluate(build_parser().parse_args())
