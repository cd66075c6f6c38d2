"""Carry model weights and optimizer state between rectpu's tree layout and the port.

A rectpu parameter tree (``Model.init`` / ``export.load_model``'s ``params``,
numpy arrays or tensors) is nested dicts and lists of leaves, e.g. DeepFM's

    packed:   {"table": [V, K+1(+pad)], "linear": {"b", ["w_num"]}, "mlp": [...]}
    unpacked: {"emb": [V, K], "linear": {"w": [V], "b", ["w_num"]}, ...}

DLRM's ``{"emb", "top": [...], ["bot": [...]]}`` or xDeepFM's ``{"table",
"linear", "cin": [{"w"}, ...], "cin_out": {"w", "b"}, "mlp"}``.
``load_params`` registers every leaf as an ``nn.Parameter`` of the model,
named after its key path (``mlp/0/kernel`` -> ``mlp.0.kernel``): a top-level
leaf is an attribute, a dict of leaves an ``nn.ParameterDict``, a dict holding
subtrees an ``nn.ModuleDict``, a list an ``nn.ModuleList`` (or an
``nn.ParameterList`` of leaves). Each leaf keeps its own dtype: the fp32
masters stay fp32 and a bf16 master (``table_dtype="bfloat16"``) stays bf16;
an integer leaf (the int8 ``q`` of a quantized serving table) does not
require grad.
``params_tree`` is the way back, for export and checkpoint.

``opt_state_tree`` / ``opt_state_from_tree`` do the same for any
optimizer's state (``train/optimizers.py``): the port keeps it as nested
dicts whose innermost dicts are keyed by parameter path (Adam's ``{"m":
{"mlp/0/kernel": t, ...}, "v": ..., "t"}``, ``per_subtree``'s ``{"linear":
{"n": {"w": t, "b": t}, ...}, "emb": {"acc": {"": t}}, ...}``); joining every
key on the way to a leaf (an empty key adds nothing) gives the leaf's path in
rectpu's state tree, whose lists are the dicts keyed 0, 1, ... of that
nesting. So one carrier serves Adam, Adagrad (with or without its ``t``),
FTRL, RMSProp, ``per_subtree``, ``bf16_param_store``'s ``{"inner",
"master"}`` and ``packed_wide_deep``'s ``{"acc", "n", "z", "linear",
"rest"}``. ``sparse_state_tree`` / ``sparse_state_from_tree`` carry the
sparse fast step's ``{"m": {"rest": tree}, "v": {"rest": tree},
"mv_sparse": {...}, "t"}`` (``rectpu/train/fast_step.py:197-215``): the rest
tree is the parameter tree without the table leaves, its ``linear`` subtree
(less an unpacked ``w``) renamed ``linear_rest``.
"""

from __future__ import annotations

import torch
from torch import nn

from rectpu_torch.train.checkpoint import _rebuild, _treedef_template, to_tensor

_SEP = "/"


def flat_params(model: nn.Module) -> dict:
    """{rectpu key path: parameter} of a model, in registration order."""
    return {name.replace(".", _SEP): p for name, p in model.named_parameters()}


def _is_leaf(node) -> bool:
    return not isinstance(node, (dict, list, tuple))


def _carry(node, param):
    """A subtree as the module (or parameter) that holds it."""
    if _is_leaf(node):
        return param(node)
    if isinstance(node, dict):
        if all(_is_leaf(v) for v in node.values()):
            return nn.ParameterDict({k: param(v) for k, v in node.items()})
        return nn.ModuleDict({k: _carry(v, param) for k, v in node.items()})
    if node and all(_is_leaf(v) for v in node):
        return nn.ParameterList(param(v) for v in node)
    return nn.ModuleList(_carry(v, param) for v in node)


def load_params(model: nn.Module, params: dict, device=None) -> nn.Module:
    """Register rectpu's tree ``params`` as the model's parameters (on
    ``device``), replacing any it held under the same names; returns the
    model."""
    device = torch.device("cpu") if device is None else torch.device(device)

    def param(leaf):
        t = to_tensor(leaf).detach().to(device).contiguous().clone()
        # an int8 leaf (a quantized serving table's "q") is a frozen parameter
        return nn.Parameter(t, requires_grad=t.is_floating_point())

    for name, node in params.items():
        if node is None:
            continue  # an empty subtree, as in JAX
        if hasattr(model, name) and name not in model._parameters and name not in model._modules:
            raise ValueError(f"parameter {name!r} would shadow the model's attribute")
        model._parameters.pop(name, None)
        model._modules.pop(name, None)
        setattr(model, name, _carry(node, param))
    return model


def _tree_of(module):
    if isinstance(module, nn.Parameter):
        return module.detach().cpu()
    if isinstance(module, nn.ParameterDict):
        return {k: p.detach().cpu() for k, p in module.items()}
    if isinstance(module, nn.ModuleDict):
        return {k: _tree_of(m) for k, m in module.items()}
    if isinstance(module, nn.ParameterList):
        return [p.detach().cpu() for p in module]
    if isinstance(module, nn.ModuleList):
        return [_tree_of(m) for m in module]
    raise TypeError(f"not a parameter container: {type(module).__name__}")


def params_tree(model: nn.Module) -> dict:
    """rectpu's parameter tree of the model: detached CPU tensors."""
    tree = {name: p.detach().cpu() for name, p in model.named_parameters(recurse=False)}
    for name, module in model.named_children():
        tree[name] = _tree_of(module)
    return tree


def _state_leaves(state: dict, path: tuple = ()):
    """(rectpu path, leaf) of every leaf of a port optimizer state; an empty
    dict is a leaf too (an optimizer without state, as SGD's)."""
    if isinstance(state, dict) and state:
        for k, v in state.items():
            yield from _state_leaves(v, path + tuple(p for p in k.split(_SEP) if p))
    else:
        yield _SEP.join(path), state


def _listify(node):
    """Dicts keyed 0..n-1 (every list of rectpu's trees) back into lists."""
    if not isinstance(node, dict) or not node:
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if all(k.isdigit() for k in out) and sorted(map(int, out)) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def opt_state_tree(state: dict) -> dict:
    """The port's optimizer state as rectpu's tree (detached CPU tensors)."""
    tree: dict = {}
    for path, leaf in _state_leaves(state):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
        if not path:
            return leaf
        node = tree
        *parents, last = path.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return _listify(tree)


def opt_state_from_tree(tree: dict, like: dict) -> dict:
    """rectpu's optimizer state tree -> the port's nesting of ``like`` (the
    optimizer's fresh ``init``), each leaf on its ``like`` leaf's device. A
    leaf missing from the tree or of another shape raises."""
    flat = flatten_tree(tree)

    def fill(node, path):
        if isinstance(node, dict) and node:
            return {k: fill(v, path + tuple(p for p in k.split(_SEP) if p))
                    for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            return node
        key = _SEP.join(path)
        if key not in flat:
            raise ValueError(f"optimizer state {key!r} is not in the checkpoint")
        got = to_tensor(flat[key])
        if tuple(got.shape) != tuple(node.shape):
            raise ValueError(f"optimizer state {key!r}: checkpoint shape "
                             f"{tuple(got.shape)}, optimizer {tuple(node.shape)}")
        return got.to(node.device).contiguous()

    return fill(like, ())


_LINEAR, _LINEAR_REST = "linear" + _SEP, "linear_rest" + _SEP


def sparse_state_tree(model, state: dict) -> dict:
    """The fast step's state (``train/fast_step.py``, flat rest subtrees) as
    rectpu's tree."""
    template = _treedef_template(params_tree(model))
    rest = {k: v for k, v in template.items() if k not in state["mv_sparse"] and k != "linear"}
    if "linear" in template:
        rest["linear_rest"] = {k: None for k in template["linear"]
                               if _LINEAR + k in state["m"]["rest"]}

    def tree(sub):
        renamed = {(_LINEAR_REST + k[len(_LINEAR):] if k.startswith(_LINEAR) else k):
                   t.detach().cpu() for k, t in sub["rest"].items()}
        return {"rest": _rebuild(rest, renamed)}

    return {"m": tree(state["m"]), "v": tree(state["v"]),
            "mv_sparse": {k: t.detach().cpu() for k, t in state["mv_sparse"].items()},
            "t": state["t"].detach().cpu().to(torch.int32)}


def sparse_state_from_tree(tree: dict, device=None) -> dict:
    """rectpu's fast-step state tree -> the port's (flat rest subtrees)."""
    def flat(sub):
        return {"rest": {(_LINEAR + k[len(_LINEAR_REST):] if k.startswith(_LINEAR_REST) else k):
                         to_tensor(v).to(device).contiguous()
                         for k, v in flatten_tree(sub["rest"]).items()}}

    return {"m": flat(tree["m"]), "v": flat(tree["v"]),
            "mv_sparse": {k: to_tensor(v).to(device).contiguous()
                          for k, v in tree["mv_sparse"].items()},
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
