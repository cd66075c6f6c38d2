"""Plain float32 xDeepFM (Lian et al., KDD 2018, arXiv:1803.05170), forward
and loss.

Imports nothing of the program. The leaves are named and laid out as the
port's tree (``emb``, ``linear/{w,b,w_num}``, ``num_emb``, ``cin/<l>/w``
[H_l, M, H_l+1], ``cin_out/{w,b}``, ``mlp/<i>/{kernel,bias}``) so that one
set of start values feeds both sides.

    x0       = [e_1 .. e_26, v_1 * u_1 .. v_13 * u_13]       [B, 39, K]
    x^{l+1}  = sum_{h,m} W^l[h, m, o] x^l[b, h, k] x0[b, m, k]
    logit    = sum_f w[id_f] + b + v . w_num                 (linear)
             + concat_l sum_k x^l . w_cin + b_cin            (CIN)
             + DNN(flatten(x0))                              (DNN)

Departures from the paper: each CIN layer's whole output feeds the next
and the pooling (direct connections; the paper splits half), and the 13
dense features enter as fields (value times a learned vector), so the CIN
sees 39 fields.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _dims(conf: dict):
    k = conf["embedding_size"]
    m = len(conf["sparse_rows"]) + conf["dense_features"]
    cin = [m] + list(conf["cin_units"])
    dnn = [m * k] + list(conf["hidden_units"]) + [1]
    return k, m, cin, dnn


def param_specs(conf: dict, table_rows: int) -> dict:
    k, m, cin, dnn = _dims(conf)
    specs = {
        "linear/w": ((table_rows,), ("zeros",)),
        "linear/b": ((), ("zeros",)),
        "linear/w_num": ((conf["dense_features"],), ("zeros",)),
        "emb": ((table_rows, k), ("trunc_normal", k ** -0.5)),
        "num_emb": ((1, conf["dense_features"], k), ("trunc_normal", k ** -0.5)),
    }
    for i in range(len(cin) - 1):
        specs[f"cin/{i}/w"] = ((cin[i], m, cin[i + 1]), ("glorot", cin[i] * m, cin[i + 1]))
    specs["cin_out/w"] = ((sum(cin[1:]), 1), ("glorot", sum(cin[1:]), 1))
    specs["cin_out/b"] = ((1,), ("zeros",))
    for i in range(len(dnn) - 1):
        specs[f"mlp/{i}/kernel"] = ((dnn[i], dnn[i + 1]), ("glorot", dnn[i], dnn[i + 1]))
        specs[f"mlp/{i}/bias"] = ((dnn[i + 1],), ("zeros",))
    return specs


TABLE_LEAVES = ("emb", "linear/w")


def lookup_width(conf: dict) -> int:
    """Columns of the table the step gathers from: the embedding and the
    linear weight, gathered together."""
    return conf["embedding_size"] + 1


def logits(conf: dict, p: dict, ids, dense, mm):
    """ids [B, F] rows of the table leaves, dense [B, 13] -> logits [B]."""
    k, m, cin, dnn = _dims(conf)
    b = ids.shape[0]
    lin = p["linear/w"][ids].sum(dim=1) + p["linear/b"] + dense @ p["linear/w_num"]
    x0 = torch.cat([p["emb"][ids], dense[:, :, None] * p["num_emb"]], dim=1)  # [B, M, K]
    x, pools = x0, []
    for i in range(len(cin) - 1):
        h = x.shape[1]
        z = (x[:, :, None, :] * x0[:, None, :, :]).permute(0, 3, 1, 2).reshape(b * k, h * m)
        x = mm(z, p[f"cin/{i}/w"].reshape(h * m, -1)).reshape(b, k, -1).transpose(1, 2)
        pools.append(x.sum(dim=2))
    cin_logit = mm(torch.cat(pools, dim=1), p["cin_out/w"])[:, 0] + p["cin_out/b"]
    y = x0.reshape(b, m * k)
    n = len(dnn) - 1
    for i in range(n):
        y = mm(y, p[f"mlp/{i}/kernel"]) + p[f"mlp/{i}/bias"]
        if i < n - 1:
            y = F.relu(y)
    return lin + cin_logit + y[:, 0]


def flops_per_example(conf: dict) -> dict:
    """Forward + backward FLOPs the math needs, by part. A CIN layer's
    contraction (2 H M O K) is needed four times: forward, and the
    gradients into x^l, into x0 and into W^l. The DNN's GEMMs three times
    (forward, weight and input gradients: the input is the embeddings). The
    CIN's output layer three times."""
    k, m, cin, dnn = _dims(conf)
    cin_f = sum(2 * cin[i] * m * cin[i + 1] * k * 4 for i in range(len(cin) - 1))
    mlp = sum(2 * dnn[i] * dnn[i + 1] * 3 for i in range(len(dnn) - 1))
    return {"mlp": mlp, "cin": cin_f, "cin_out": 2 * sum(cin[1:]) * 3}
