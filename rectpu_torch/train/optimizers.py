"""Optimizers with TF-1.x update semantics: the port of ``rectpu/train/optimizers.py``.

rectpu's registry (``get_optimizer``: Adagrad, Adam, Ftrl, RMSProp, SGD) and
its combinators, each reproducing its ``tf.train.*Optimizer`` rule and
defaults, TF's initial accumulator values included:

  - ``adam`` (rectpu :96-226): lr_t = lr*sqrt(1-b2^t)/(1-b1^t),
    p -= lr_t*m/(sqrt(v)+eps) with eps OUTSIDE the square root,
    reduced-precision slots (``slot_dtype``: None, a dtype, or ``{"m": ...,
    "v": ...}`` with ``BF16_SR`` for stochastically rounded bf16), a bf16
    master updated in fp32 and rounded stochastically, and ``fused_leaves``
    that route a [V, W] leaf to the one-sweep kernel (``ops/fused_adam``: the
    CUDA kernel on the card, its plain version on the CPU);
  - ``sgd`` (:83); ``adagrad`` (:229), accumulator from 0.1, optionally
    stored in bf16 or stochastically rounded bf16 (then with a step counter
    ``t`` that seeds the rounding); ``rmsprop`` (:294), mean square from ONES;
    ``ftrl`` (:321), FTRL-proximal with ``learning_rate_power=-0.5`` only;
  - ``per_subtree`` (:368): one optimizer per top-level key of the tree
    (Wide&Deep's FTRL on ``linear``, Adagrad elsewhere);
  - ``bf16_param_store`` (:393): the forward reads bf16 copies of the table
    leaves while the fp32 masters ride in the state; its ``prepare`` makes
    the stored leaves, once, after ``init``;
  - ``packed_wide_deep`` (:489): Adagrad on the deep columns [:K] and FTRL on
    the wide column K of Wide&Deep's packed [V, K+1(+pad)] table. Unlike
    rectpu, which rebuilds the table as [V, K+1] and so drops the pad
    columns ``packed_col_pad`` added, the port writes the K+1 updated columns
    back into the table and leaves the pad at zero: the leaf keeps its shape.

``torch.optim`` does not reproduce these semantics and is not used.

Interface: ``opt.init(params)`` -> a state of nested dicts whose innermost
dicts mirror the parameters, keyed by parameter path (Adam: ``{"m": {key:
t}, "v": {key: t}, "t": int32 scalar}``); ``opt.update(grads, state,
params, scalars=None)`` updates the parameter tensors and the state in
place. ``scalars`` (``train/dispatch``) is the step's: its ``t`` seeds the
stochastic rounding, its ``lr_t(lr, beta1, beta2)`` is Adam's rate, and
``commit`` stores ``t`` in the state; host numbers (``StepScalars``) or 0-d
device tensors that a CUDA graph of the step reads (``DeviceScalars``, whose
``commit`` leaves the counter to the loop). Its ``sr_index(key, leaf)`` says
where a sharded leaf sits in rectpu's global array (a
``utils.hash32.GlobalIndex``, from ``ParallelPlan.sr_index``; None for a
whole leaf), so that every stochastic rounding keys an element on its global
flat index, as rectpu's does under GSPMD. None takes the step after the
state's own counter, on the host, with whole leaves. ``params``
and ``grads`` are flat dicts keyed by rectpu's tree paths (``"table"``,
``"mlp/0/kernel"``), so ``fused_leaves`` and the combinators name top-level
leaves as rectpu's do; ``per_subtree`` hands each optimizer its subtree keyed
by the path below the top-level key (``""`` for a top-level leaf).
``convert.opt_state_tree`` joins the keys of such a state into rectpu's tree.

The updates mirror JAX's type rules where they differ from PyTorch's: a
Python float meets a bf16 array in bf16 (JAX's weak types: the constant is
rounded to bf16 first), and a 0-d fp32 ``lr_t`` promotes a bf16 slot to
fp32. Tensor-with-tensor arithmetic promotes as in JAX (a bf16 cotangent
against an fp32 slot computes in fp32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from rectpu_torch.ops.fused_adam import fused_adam_table, stochastic_round_bf16
from rectpu_torch.train.dispatch import StepScalars

__all__ = ["BF16_SR", "Adam", "Optimizer", "adagrad", "adam", "bf16_param_store", "ftrl",
           "get_optimizer", "packed_wide_deep", "per_subtree", "rmsprop", "sgd",
           "stochastic_round_bf16"]

BF16_SR = "bfloat16_sr"  # slot-dtype token: bf16 storage with stochastic rounding


def _weak(c: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as JAX's weak type: it takes the array's dtype. (A
    fill, not a host-to-device copy, so the step does not wait for the card.)"""
    return torch.full((), c, dtype=like.dtype, device=like.device)


def _scale(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c * x`` under JAX's rules: an fp32 x takes c as fp32 (a Python
    float does the same here), a bf16 x takes c rounded to bf16."""
    return c * x if x.dtype == torch.float32 else _weak(c, x) * x


def _g32(g: torch.Tensor) -> torch.Tensor:
    """A (possibly bf16) cotangent upcast to fp32 before slot products
    (rectpu :38-42): g^2 of a bf16 g in bf16 would round each increment."""
    return g if g.dtype == torch.float32 else g.float()


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write an update into its tensor in place (in the tensor's dtype)."""
    if src is not dst:
        dst.copy_(src)


@dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``, ``update(grads, state, params)`` in place;
    ``prepare(params) -> params``, when set, makes the stored parameters from
    the fp32 ones ``init`` saw (the Trainer applies it once after ``init``)."""

    name: str
    init: Callable
    update: Callable
    prepare: Callable | None = None


class Adam:
    """tf.train.AdamOptimizer with rectpu's options (see the module docstring)."""

    name = "Adam"

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8, slot_dtype=None,
                 fused_leaves: tuple = ()):
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        if isinstance(slot_dtype, dict):
            self.m_dtype, self.v_dtype = slot_dtype.get("m"), slot_dtype.get("v")
        else:
            self.m_dtype = self.v_dtype = slot_dtype
        self.fused_leaves = tuple(fused_leaves)

    @staticmethod
    def _storage(dt):
        return torch.bfloat16 if dt == BF16_SR else dt

    def init(self, params: dict) -> dict:
        def zeros(p, dt):
            return torch.zeros_like(p, dtype=self._storage(dt) or p.dtype)

        return {
            "m": {k: zeros(p, self.m_dtype) for k, p in params.items()},
            "v": {k: zeros(p, self.v_dtype) for k, p in params.items()},
            "t": torch.zeros((), dtype=torch.int32),
        }

    @staticmethod
    def _up(x, dt):
        return x.float() if dt is not None else x

    @staticmethod
    def _down(x, dt, t, orig_dtype, index):
        if dt == BF16_SR:
            return stochastic_round_bf16(x, t, index)
        if dt is None:
            # slots follow the param dtype: the fp32 slot math must not widen a bf16 slot
            return x.to(orig_dtype)
        return x.to(dt)

    def _fusable(self, key: str, p: torch.Tensor) -> bool:
        return key in self.fused_leaves and p.dim() == 2

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, scalars=None) -> None:
        scalars = scalars or StepScalars.after(state)
        t = scalars.t
        # the fp32 rate, a Python float on the host path: it multiplies an fp32
        # tensor exactly as the 0-d fp32 array does in rectpu, with no copy to
        # the card (a 0-d fp32 tensor in a captured step)
        lr_t = scalars.lr_t(self.learning_rate, self.beta1, self.beta2)
        for key, p in params.items():
            g = grads[key]
            m, v = state["m"][key], state["v"][key]
            index = scalars.sr_index(key, p)
            if self._fusable(key, p):
                out = fused_adam_table(
                    p.detach(), m, v, g.contiguous(), t, lr=self.learning_rate,
                    beta1=self.beta1, beta2=self.beta2, eps=self.epsilon,
                    m_sr=self.m_dtype == BF16_SR, v_sr=self.v_dtype == BF16_SR, lr_t=lr_t,
                    index=index)
            else:
                out = self._leaf_update(p.detach(), m, v, g, t, lr_t, index)
            for dst, src in zip((p, m, v), out):
                if src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)
        scalars.commit(state)

    def _leaf_update(self, p, m, v, g, t, lr_t, index):
        """One leaf of rectpu's ``_treemap_update`` (optimizers.py:192-224);
        ``index``: the leaf's place in its global array (None: whole)."""
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        g32 = g.float()
        mu, vu = self._up(m, self.m_dtype), self._up(v, self.v_dtype)
        m_new = self._down(_weak(b1, mu) * mu + (1 - b1) * g32, self.m_dtype, t, m.dtype, index)
        v_new = self._down(_weak(b2, vu) * vu + (1 - b2) * g32 * g32, self.v_dtype, t,
                           v.dtype, index)
        mu, vu = self._up(m_new, self.m_dtype), self._up(v_new, self.v_dtype)
        upd = lr_t * mu.float() / (torch.sqrt(vu) + _weak(eps, vu))
        if p.dtype == torch.bfloat16:
            # bf16 master: fp32 update math, stochastically rounded, seeded
            # away from the slots' draws
            p_new = stochastic_round_bf16(p.float() - upd, t + (1 << 30), index)
        else:
            p_new = p - upd
        return p_new, m_new, v_new


def adam(learning_rate: float = 0.001, beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-8, slot_dtype=None, fused_leaves: tuple = ()) -> Adam:
    return Adam(learning_rate, beta1, beta2, epsilon, slot_dtype, fused_leaves)


def sgd(learning_rate: float = 0.001) -> Optimizer:
    """tf.train.GradientDescentOptimizer (rectpu :83): p -= lr * g."""

    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, scalars=None):
        for key, p in params.items():
            _assign(p, p - _scale(learning_rate, grads[key]))

    return Optimizer("SGD", init, update)


def adagrad(learning_rate: float = 0.001, initial_accumulator_value: float = 0.1,
            slot_dtype=None) -> Optimizer:
    """tf.train.AdagradOptimizer (rectpu :229-291): acc starts at 0.1,
    acc += g^2 (fp32 g^2 even for a bf16 g), p -= lr * g / sqrt(acc) with the
    STORED accumulator. ``slot_dtype`` stores acc reduced (fp32 math); with
    ``BF16_SR`` it is rounded stochastically, seeded by a step counter ``t``
    that the state then holds."""
    sr = slot_dtype == BF16_SR
    store = torch.bfloat16 if sr else slot_dtype

    def init(params):
        state = {"acc": {k: torch.full_like(p, initial_accumulator_value, dtype=store or p.dtype)
                         for k, p in params.items()}}
        if sr:
            state["t"] = torch.zeros((), dtype=torch.int32)
        return state

    def up(a):
        return a.float() if slot_dtype is not None else a

    @torch.no_grad()
    def update(grads, state, params, scalars=None):
        t = None
        if "t" in state:
            scalars = scalars or StepScalars.after(state)
            t = scalars.t
        for key, p in params.items():
            g, a = grads[key], state["acc"][key]
            g32 = _g32(g)
            if slot_dtype is None:
                a_new = (a + g32 * g32).to(a.dtype)
            elif sr:
                a_new = stochastic_round_bf16(up(a) + g32 * g32, t, scalars.sr_index(key, p))
            else:
                a_new = (up(a) + g32 * g32).to(slot_dtype)
            _assign(p, p - _scale(learning_rate, g) / torch.sqrt(up(a_new)))
            _assign(a, a_new)
        if t is not None:
            scalars.commit(state)

    return Optimizer("Adagrad", init, update)


def rmsprop(learning_rate: float = 0.001, decay: float = 0.9, momentum: float = 0.0,
            epsilon: float = 1e-10) -> Optimizer:
    """tf.train.RMSPropOptimizer (rectpu :294-318): ms starts at ONES,
    ms = decay*ms + (1-decay)*g*g, mom = momentum*mom + lr*g/sqrt(ms+eps),
    p -= mom."""

    def init(params):
        return {"ms": {k: torch.ones_like(p) for k, p in params.items()},
                "mom": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, scalars=None):
        for key, p in params.items():
            g, s, mo = grads[key], state["ms"][key], state["mom"][key]
            ms = _scale(decay, s) + _scale(1 - decay, g) * g
            mom = _scale(momentum, mo) + _scale(learning_rate, g) / torch.sqrt(
                ms + _weak(epsilon, ms))
            _assign(p, p - mom)
            _assign(s, ms)
            _assign(mo, mom)

    return Optimizer("RMSProp", init, update)


def _ftrl_step(w, g, n, z, learning_rate: float, l1: float = 0.0, l2: float = 0.0):
    """One FTRL-proximal leaf with lr_power=-0.5 (rectpu :343-361):
    (w', n', z')."""
    g32 = _g32(g)
    n_new = (n + g32 * g32).to(n.dtype)
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / learning_rate
    z_new = z + g - sigma * w
    quad = torch.sqrt(n_new) / learning_rate + 2.0 * l2
    w_new = -(z_new - torch.sign(z_new) * l1) / quad
    return torch.where(torch.abs(z_new) > l1, w_new, torch.zeros_like(w_new)), n_new, z_new


def ftrl(learning_rate: float = 0.001, learning_rate_power: float = -0.5,
         initial_accumulator_value: float = 0.1, l1_regularization_strength: float = 0.0,
         l2_regularization_strength: float = 0.0) -> Optimizer:
    """tf.train.FtrlOptimizer (FTRL-proximal, rectpu :321-365), TF defaults.
    With lr_power=-0.5: n' = n + g^2; sigma = (sqrt(n') - sqrt(n)) / lr;
    z' = z + g - sigma*w; w' = -(z' - sign(z')*l1) / (sqrt(n')/lr + 2*l2)
    where |z'| > l1, else 0."""
    if learning_rate_power != -0.5:
        raise NotImplementedError("only learning_rate_power=-0.5 (TF default) supported")
    l1, l2 = l1_regularization_strength, l2_regularization_strength

    def init(params):
        return {"n": {k: torch.full_like(p, initial_accumulator_value)
                      for k, p in params.items()},
                "z": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, scalars=None):
        for key, p in params.items():
            n, z = state["n"][key], state["z"][key]
            w_new, n_new, z_new = _ftrl_step(p, grads[key], n, z, learning_rate, l1, l2)
            _assign(p, w_new)
            _assign(n, n_new)
            _assign(z, z_new)

    return Optimizer("Ftrl", init, update)


_SEP = "/"


def _top(key: str) -> tuple[str, str]:
    """(top-level key, the path below it: "" for a top-level leaf)."""
    top, _, rest = key.partition(_SEP)
    return top, rest


def _subtrees(tree: dict) -> dict:
    """{top-level key: {path below it: tensor}} of a flat parameter dict."""
    out: dict = {}
    for key, x in tree.items():
        top, rest = _top(key)
        out.setdefault(top, {})[rest] = x
    return out


def per_subtree(mapping: dict, default) -> Optimizer:
    """Different optimizers for different top-level subtrees (rectpu
    :368-390): DNNLinearCombined's FTRL on 'linear' and Adagrad on the deep
    tower. The state is keyed by top-level key, each holding its optimizer's
    state of that subtree; each optimizer's scalars (``within``) name the
    leaves by their full paths."""

    def opt_for(key):
        return mapping.get(key, default)

    def init(params):
        return {k: opt_for(k).init(sub) for k, sub in _subtrees(params).items()}

    def update(grads, state, params, scalars=None):
        sub_g = _subtrees(grads)
        for k, sub in _subtrees(params).items():
            opt_for(k).update(sub_g[k], state[k], sub, scalars and scalars.within(k))

    names = ",".join(f"{k}:{v.name}" for k, v in mapping.items()) + f",*:{default.name}"
    return Optimizer(f"PerSubtree({names})", init, update)


def bf16_param_store(inner, leaves: tuple = ("table", "emb"),
                     dtype: torch.dtype = torch.bfloat16) -> Optimizer:
    """The forward reads ``dtype`` copies of the top-level ``leaves`` while
    their fp32 masters ride in the state and every update is fp32 (rectpu
    :393-459). ``init`` takes the fp32 parameters of ``model.init``;
    ``prepare`` then stores the leaves in ``dtype``; ``update`` runs
    ``inner`` on the masters and writes the fresh copies. With a compute
    dtype of ``dtype`` the forward reads the same values either way; the
    table cotangent is then ``dtype`` (the primal's), which ``inner`` upcasts
    as a bf16 cotangent. State: ``{"inner": ..., "master": {leaf: fp32}}``."""

    def picked(params):
        return {k: params[k] for k in leaves if k in params}

    def init(params):
        master = picked(params)
        for k, p in master.items():
            if p.dtype != torch.float32:
                raise ValueError(
                    f"bf16_param_store.init needs fp32 masters; param {k!r} is "
                    f"{p.dtype} (init from model.init output, not prepared params)")
        return {"inner": inner.init(params),
                "master": {k: p.detach().clone() for k, p in master.items()}}

    def prepare(params):
        return {**params, **{k: v.to(dtype) for k, v in picked(params).items()}}

    @torch.no_grad()
    def update(grads, state, params, scalars=None):
        master = state["master"]
        inner.update(grads, state["inner"], {**params, **master}, scalars)
        for k, m in master.items():
            params[k].copy_(m.to(dtype))

    return Optimizer(f"{inner.name}+Bf16Store", init, update, prepare=prepare)


_REGISTRY = {"Adagrad": adagrad, "Adam": adam, "Ftrl": ftrl, "RMSProp": rmsprop, "SGD": sgd}


def get_optimizer(optimizer_name: str = "Adam", learning_rate: float = 0.001,
                  slot_dtype=None):
    """Name-based factory (ref trainers/model_utils.py:57-66). ``slot_dtype``
    asks for reduced-precision slots (Adam and Adagrad)."""
    if slot_dtype is not None:
        if optimizer_name == "Adam":
            return adam(learning_rate=learning_rate, slot_dtype=slot_dtype)
        if optimizer_name == "Adagrad":
            return adagrad(learning_rate=learning_rate, slot_dtype=slot_dtype)
        raise ValueError(
            f"slot_dtype is only supported for Adam/Adagrad, got {optimizer_name}")
    return _REGISTRY[optimizer_name](learning_rate=learning_rate)


def packed_wide_deep(embedding_size: int, linear_lr: float, deep_lr: float = 0.05) -> Optimizer:
    """Column-split optimizer for Wide&Deep's packed [V, K+1(+pad)] ``table``
    (rectpu :489-562): Adagrad(deep_lr) on the embedding columns [:K], FTRL
    (linear_lr, TF defaults) on the wide column K; FTRL on the rest of the
    ``linear`` subtree (bias, numeric weights), Adagrad on every other leaf:
    the update of the unpacked per_subtree({linear: ftrl}, adagrad). The
    state is rectpu's ``{"acc": [V, K], "n": [V], "z": [V], "linear": ...,
    "rest": ...}``. The pad columns keep their zeros (rectpu drops them,
    see the module docstring)."""
    k = embedding_size
    ada = adagrad(learning_rate=deep_lr)
    ft = ftrl(learning_rate=linear_lr)

    def split(tree):
        linear = {rest: x for key, x in tree.items()
                  for top, rest in [_top(key)] if top == "linear"}
        other = {key: x for key, x in tree.items()
                 if key != "table" and _top(key)[0] != "linear"}
        return tree["table"], linear, other

    def init(params):
        table, linear, other = split(params)
        return {"acc": torch.full_like(table[:, :k], 0.1),
                "n": torch.full_like(table[:, k], 0.1),
                "z": torch.zeros_like(table[:, k]),
                "linear": ft.init(linear), "rest": ada.init(other)}

    @torch.no_grad()
    def update(grads, state, params, scalars=None):
        table, p_lin, p_other = split(params)
        g_table, g_lin, g_other = split(grads)
        # deep columns: Adagrad
        g_emb = g_table[:, :k]
        g32 = _g32(g_emb)
        acc = state["acc"] + g32 * g32
        emb_new = table[:, :k] - _scale(deep_lr, g_emb) / torch.sqrt(acc)
        # wide column: FTRL-proximal (l1 = l2 = 0)
        g_w, w = g_table[:, k], table[:, k]
        gw32 = _g32(g_w)
        n_new = state["n"] + gw32 * gw32
        sigma = (torch.sqrt(n_new) - torch.sqrt(state["n"])) / linear_lr
        z_new = state["z"] + g_w - sigma * w
        w_new = -z_new / (torch.sqrt(n_new) / linear_lr)
        table[:, :k].copy_(emb_new)
        table[:, k].copy_(w_new)
        _assign(state["acc"], acc)
        _assign(state["n"], n_new)
        _assign(state["z"], z_new)
        if p_lin:
            ft.update(g_lin, state["linear"], p_lin, scalars)
        ada.update(g_other, state["rest"], p_other, scalars)

    return Optimizer("PackedWideDeep(Ftrl+Adagrad)", init, update)
