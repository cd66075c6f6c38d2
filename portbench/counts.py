"""Peaks of the card and the work a step needs, counted from the
configuration's shapes.

Peaks are those of the fastest route that keeps the configuration's
precision (NVIDIA H100 SXM data sheet, dense): float32 work at 165 TFLOP/s,
the 3xTF32 route (495 / 3) that keeps float32 accuracy and that the port's
float32 CIN already takes; bfloat16 work at 989 TFLOP/s; memory at 3.35
TB/s. The rates assume the card's full 700 W; ``power_limit`` reads the
limit the card is set to, printed beside them.

Work is what the configuration's math needs, whatever implements it: each
input byte read once, each output byte written once, each distinct table
row once; SGD touches only the rows its batch touches; dense Adam, as
TensorFlow defines it, reads and writes every element of p, m and v.
"""

from __future__ import annotations

import subprocess

PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
F32 = 4  # bytes
ID = 4  # an int32 row id


def power_limit() -> str:
    """The card's name and power limit by ``nvidia-smi``, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()


def peak_flops(conf: dict) -> float:
    return PEAK_FLOPS[conf.get("precision", "float32")]


def bound_s(flops: float = 0.0, nbytes: float = 0.0, conf: dict | None = None) -> float:
    """The least time the card could take: the larger of the FLOPs and the
    bytes bounds."""
    return max(flops / peak_flops(conf or {}), nbytes / PEAK_BYTES)


def lookup_bytes(batch: int, fields: int, width: int, distinct: float) -> float:
    """The gather: ids read, each distinct row read once, rows written."""
    return batch * fields * ID + distinct * width * F32 + batch * fields * width * F32


def table_grad_bytes(batch: int, fields: int, width: int, distinct: float) -> float:
    """The table's gradient: row gradients and ids read, one summed row a
    distinct id written."""
    return batch * fields * (width * F32 + ID) + distinct * width * F32


def optimizer_bytes(name: str, leaves: dict, table_leaves, distinct: float) -> float:
    """``leaves``: {key: (rows, elements)}. SGD (p -= lr g) reads p and g
    and writes p, of a table only the distinct rows a step touches; dense
    Adam reads p, m, v and g and writes p, m and v of every element."""
    total = 0.0
    for key, (rows, elems) in leaves.items():
        if name == "SGD":
            n = distinct * (elems // rows) if key in table_leaves else elems
            total += 3 * F32 * n
        elif name == "Adam":
            total += 7 * F32 * elems
        else:
            raise ValueError(f"no byte count for {name}")
    return total

