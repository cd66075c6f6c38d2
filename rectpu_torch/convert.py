"""Carry rectpu's DeepFM weights across into the port's module state.

Input: rectpu's DeepFM parameter tree (``DeepFMModel.init`` /
``export.load_model``'s ``params``) as numpy arrays or CPU tensors, in either
form rectpu writes:

    packed:   {"table": [V, K+1(+pad)], "linear": {"b", ["w_num"]}, ...}
    unpacked: {"emb": [V, K], "linear": {"w": [V], "b", ["w_num"]}, ...}

plus ``num_emb`` [1, N, K] with numeric features and ``mlp`` [{"kernel",
"bias"}, ...] with the DNN. Output: ``{buffer name: tensor}`` on ``device``,
for ``DeepFMModel.load_state``. What rectpu does on every call is done here
once: the fused ``[V, K+1]`` table is assembled from ``emb`` and
``linear.w`` (``pack_fused_table``), and under a bf16 compute dtype the table,
the dense kernels and the hidden biases are cast to bf16 (elementwise the same
as rectpu's casts inside each forward).
"""

from __future__ import annotations

from rectpu_torch.models.base import pack_fused_table
from rectpu_torch.train.checkpoint import to_tensor


def deep_fm_state(model, params: dict, device) -> dict:
    cfg = model.cfg
    cd = cfg.torch_compute_dtype
    linear = {k: to_tensor(v) for k, v in params.get("linear", {}).items()}
    state = {}
    if model.use_linear:
        state["linear_b"] = linear["b"]
        if "w_num" in linear:
            state["linear_w_num"] = linear["w_num"]
        if not model.fused:
            state["linear_w"] = linear["w"].reshape(-1, 1)
    if model.use_mf or model.use_dnn:
        if model.packed:
            table = to_tensor(params["table"])
        elif model.fused:
            table = pack_fused_table(to_tensor(params["emb"]), linear["w"])
        else:
            table = to_tensor(params["emb"])
        state["table"] = table.to(cd) if cd is not None else table
        if cfg.num_numeric:
            state["num_emb"] = to_tensor(params["num_emb"])
    if model.use_dnn:
        layers = params["mlp"]
        for i, layer in enumerate(layers):
            kernel, bias = to_tensor(layer["kernel"]), to_tensor(layer["bias"])
            if cd is not None:
                kernel = kernel.to(cd)
                if i < len(layers) - 1:  # the logit layer's bias stays fp32
                    bias = bias.to(cd)
            state[f"mlp_{i}_kernel"] = kernel
            state[f"mlp_{i}_bias"] = bias
    return {name: t.to(device).contiguous() for name, t in state.items()}
