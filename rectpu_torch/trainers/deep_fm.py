"""DeepFM trainer CLI: the port of ``rectpu/trainers/deep_fm.py``.

logits = linear + FM + DNN over a shared embedding input layer; Adam(1e-3).
The flags are rectpu's (``trainers/deep_fm.py:22-107``) plus ``--device``:

    python -m rectpu_torch.trainers.deep_fm --preset scaled --embedding-size 64 \\
        --hidden-units 256 128 --batch-size 4096 --train-steps 100 --job-dir <dir>

trains on the card (``--device cpu`` runs the plain PyTorch versions of the
kernels) and writes checkpoints and exports in rectpu's layout. The
--exclude-* flags are honored as intended, as in rectpu.
"""

from __future__ import annotations

from argparse import ArgumentParser

import torch

from rectpu_torch.features.schema import ml_100k_feature_set
from rectpu_torch.models import DeepFMModel, TowerConfig
from rectpu_torch.trainers.common import add_common_args, add_deep_args, apply_preset, run
from rectpu_torch.train.optimizers import BF16_SR, get_optimizer

_SLOT_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bfloat16-m": {"m": torch.bfloat16},
    "bfloat16-sr": {"m": torch.bfloat16, "v": BF16_SR},
}


def build_model(args) -> DeepFMModel:
    cfg = TowerConfig(
        feature_set=ml_100k_feature_set(numeric=tuple(args.numeric_columns or ())),
        embedding_size=args.embedding_size,
        hidden_units=tuple(args.hidden_units),
        dropout=args.dropout,
        dropout_impl=args.dropout_impl,
        embedding_impl=args.embedding_impl,
        fm_impl=args.fm_impl,
        compute_dtype=args.compute_dtype,
        table_grad_dtype=args.table_grad_dtype,
        table_dtype=args.table_dtype,
        packed_linear=args.packed_linear or args.flat_layout,
        packed_col_pad=args.packed_col_pad,
        flat_layout=args.flat_layout,
        scatter_impl=args.scatter_impl,
        table_padding=2048 if args.scatter_impl in ("mxu", "auto") else 128,
    )
    return DeepFMModel(cfg, use_linear=not args.exclude_linear, use_mf=not args.exclude_mf,
                       use_dnn=not args.exclude_dnn, fm_order=args.fm_order)


def train_and_evaluate(args):
    """Train and evaluate from parsed args; returns (final metrics, trainer)."""
    args = apply_preset(args)
    model = build_model(args)
    slot_dtype = _SLOT_DTYPES[args.optimizer_slot_dtype] if args.optimizer_slot_dtype else None
    optimizer = get_optimizer(args.optimizer, args.learning_rate, slot_dtype=slot_dtype)
    return run(args, model, optimizer)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    add_common_args(parser, job_dir_default="checkpoints/deep_fm")
    add_deep_args(parser)
    parser.add_argument("--exclude-linear", action="store_true",
                        help="flag to exclude linear component (default: %(default)s)")
    parser.add_argument("--exclude-mf", action="store_true",
                        help="flag to exclude mf component (default: %(default)s)")
    parser.add_argument("--exclude-dnn", action="store_true",
                        help="flag to exclude dnn component (default: %(default)s)")
    parser.add_argument("--optimizer", default="Adam",
                        choices=["Adagrad", "Adam", "Ftrl", "RMSProp", "SGD"],
                        help="optimizer (default: %(default)s; only Adam is ported)")
    parser.add_argument("--learning-rate", type=float, default=0.001,
                        help="learning rate (default: %(default)s)")
    parser.add_argument("--optimizer-slot-dtype", default=None,
                        choices=[None, "bfloat16", "bfloat16-m", "bfloat16-sr"],
                        help="reduced-precision Adam slots (fp32 math): 'bfloat16-m' first "
                             "moment in bf16; 'bfloat16-sr' both moments bf16, v "
                             "stochastically rounded; 'bfloat16' both plain bf16. "
                             "default: float32")
    parser.add_argument("--fm-order", type=int, default=2, choices=[2, 3],
                        help="highest FM interaction order (default: %(default)s)")
    parser.add_argument("--numeric-columns", nargs="*", default=[],
                        help="numeric feature columns fed via the value*vector embedding trick")
    parser.add_argument("--packed-linear", action="store_true",
                        help="store the fused [V, K+1] embedding+linear table as one parameter")
    parser.add_argument("--packed-col-pad", type=int, default=0,
                        help="pad the packed table width to this multiple (default: "
                             "%(default)s)")
    return parser


if __name__ == "__main__":
    train_and_evaluate(build_parser().parse_args())
