"""Plain float32 DLRM (Naumov et al., arXiv:1906.00091), forward and loss.

Imports nothing of the program. The leaves are named and laid out as the
port's tree (``emb``, ``bot/<i>/{kernel,bias}``, ``top/<i>/{kernel,bias}``)
so that one set of start values feeds both sides. Departures from
facebookresearch/dlrm's ``interact_features``, none of which changes the
function class: the vectors are ordered [e_1 .. e_26, d0] (dlrm: d0 first)
and the pairs are the upper triangle in row-major order (dlrm: the lower
triangle), which permutes the rows of the top MLP's first kernel.

``mm`` is the matrix product the caller chooses: float32 with TF32 off, or
the control's TF32 (``refstep.mm_for``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _dims(conf: dict):
    k = conf["embedding_size"]
    bot = [conf["dense_features"]] + list(conf["bot_hidden_units"]) + [k]
    n = len(conf["sparse_rows"]) + 1
    top_in = k + n * (n - 1) // 2
    top = [top_in] + list(conf["hidden_units"]) + [1]
    return k, bot, top


def param_specs(conf: dict, table_rows: int) -> dict:
    """{leaf: (shape, init)}: the table truncated normal with stddev
    1/sqrt(K) over ``table_rows`` rows (the vocabulary and its padding),
    glorot-uniform kernels, zero biases."""
    k, bot, top = _dims(conf)
    specs = {"emb": ((table_rows, k), ("trunc_normal", k ** -0.5))}
    for name, dims in (("top", top), ("bot", bot)):
        for i in range(len(dims) - 1):
            specs[f"{name}/{i}/kernel"] = ((dims[i], dims[i + 1]),
                                           ("glorot", dims[i], dims[i + 1]))
            specs[f"{name}/{i}/bias"] = ((dims[i + 1],), ("zeros",))
    return specs


TABLE_LEAVES = ("emb",)


def lookup_width(conf: dict) -> int:
    """Columns of the table the step gathers from."""
    return conf["embedding_size"]


def _mlp(p, prefix: str, n: int, x, mm, last_act: bool):
    for i in range(n):
        x = mm(x, p[f"{prefix}/{i}/kernel"]) + p[f"{prefix}/{i}/bias"]
        if i < n - 1 or last_act:
            x = F.relu(x)
    return x


def logits(conf: dict, p: dict, ids, dense, mm):
    """ids [B, F] rows of p["emb"], dense [B, 13] -> logits [B]."""
    k, bot, top = _dims(conf)
    e = p["emb"][ids]
    d0 = _mlp(p, "bot", len(bot) - 1, dense, mm, last_act=True)
    v = torch.cat([e, d0[:, None, :]], dim=1)
    n = v.shape[1]
    z = mm(v, v.transpose(1, 2))
    iu, ju = torch.triu_indices(n, n, 1, device=v.device)
    x = torch.cat([d0, z[:, iu, ju]], dim=1)
    return _mlp(p, "top", len(top) - 1, x, mm, last_act=False)[:, 0]


def flops_per_example(conf: dict) -> dict:
    """Forward + backward FLOPs the math needs, by part: every GEMM's
    forward, weight gradient and input gradient, but no input gradient of
    the bottom MLP's first layer (its input is data); the interaction's
    pair dots forward and their gradient into both vectors."""
    k, bot, top = _dims(conf)
    mlp = 0
    for dims, first_dx in ((bot, False), (top, True)):
        for i in range(len(dims) - 1):
            mac = dims[i] * dims[i + 1]
            mlp += 2 * mac * (3 if (i > 0 or first_dx) else 2)
    n = len(conf["sparse_rows"]) + 1
    pairs = n * (n - 1) // 2
    return {"mlp": mlp, "interaction": 2 * pairs * k * 3}
