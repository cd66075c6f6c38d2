"""Carry DeepFM weights and Adam state between rectpu's tree layout and the port.

rectpu's DeepFM parameter tree (``DeepFMModel.init`` / ``export.load_model``'s
``params``, numpy arrays or tensors) comes in either form rectpu writes:

    packed:   {"table": [V, K+1(+pad)], "linear": {"b", ["w_num"]}, ...}
    unpacked: {"emb": [V, K], "linear": {"w": [V], "b", ["w_num"]}, ...}

plus ``num_emb`` [1, N, K] with numeric features and ``mlp`` [{"kernel",
"bias"}, ...] with the DNN. ``load_deep_fm_params`` makes each leaf an
``nn.Parameter`` of the model, named after its key path (``mlp/0/kernel`` ->
``mlp.0.kernel``), in the leaf's own dtype: the fp32 masters stay fp32 and a
bf16 master (``table_dtype="bfloat16"``) stays bf16. ``deep_fm_tree`` is the
way back, for export and checkpoint.

``adam_state_tree`` / ``adam_state_from_tree`` do the same for the Adam state
``{"m": tree, "v": tree, "t": int32}``, whose m and v trees mirror the
parameter tree (``rectpu/train/optimizers.py:138-142``).
"""

from __future__ import annotations

import torch
from torch import nn

from rectpu_torch.train.checkpoint import _rebuild, _treedef_template, to_tensor

_SEP = "/"


def flat_params(model: nn.Module) -> dict:
    """{rectpu key path: parameter} of a model, in registration order."""
    return {name.replace(".", _SEP): p for name, p in model.named_parameters()}


def load_deep_fm_params(model, params: dict, device=None):
    """Register rectpu's tree ``params`` as the model's parameters (on
    ``device``); returns the model."""
    device = torch.device("cpu") if device is None else torch.device(device)

    def param(leaf):
        return nn.Parameter(to_tensor(leaf).detach().to(device).contiguous().clone())

    for name in ("table", "emb", "num_emb"):
        if name in params:
            setattr(model, name, param(params[name]))
    if "linear" in params:
        model.linear = nn.ParameterDict({k: param(v) for k, v in params["linear"].items()})
    if "mlp" in params:
        model.mlp = nn.ModuleList(
            nn.ParameterDict({k: param(v) for k, v in layer.items()}) for layer in params["mlp"])
    return model


def deep_fm_tree(model) -> dict:
    """rectpu's parameter tree of the model: detached CPU tensors."""
    tree = {name: p.detach().cpu() for name, p in model.named_parameters(recurse=False)}
    if "linear" in model._modules:
        tree["linear"] = {k: p.detach().cpu() for k, p in model.linear.items()}
    if "mlp" in model._modules:
        tree["mlp"] = [{k: p.detach().cpu() for k, p in layer.items()} for layer in model.mlp]
    return tree


def adam_state_tree(model, state: dict) -> dict:
    """The port's Adam state as rectpu's ``{"m": tree, "v": tree, "t"}``."""
    template = _treedef_template(deep_fm_tree(model))
    return {
        "m": _rebuild(template, {k: t.detach().cpu() for k, t in state["m"].items()}),
        "v": _rebuild(template, {k: t.detach().cpu() for k, t in state["v"].items()}),
        "t": state["t"].detach().cpu().to(torch.int32),
    }


def adam_state_from_tree(tree: dict, device=None) -> dict:
    """rectpu's Adam state tree -> the port's ``{"m": {key: t}, "v": ..., "t"}``."""
    def flat(sub):
        return {k: to_tensor(v).to(device).contiguous() for k, v in flatten_tree(sub).items()}

    return {"m": flat(tree["m"]), "v": flat(tree["v"]),
            "t": to_tensor(tree["t"]).to(torch.int32).reshape(())}


def flatten_tree(tree, prefix: str = "") -> dict:
    """{key path: leaf} of a dict/list tree, leaves as they are."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}{_SEP}"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out
