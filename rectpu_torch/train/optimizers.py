"""Adam with TF-1.x update semantics: the port of ``rectpu/train/optimizers.py``.

``adam`` reproduces ``tf.train.AdamOptimizer`` as rectpu's ``adam`` does
(``rectpu/train/optimizers.py:96-226``): lr_t = lr*sqrt(1-b2^t)/(1-b1^t),
p -= lr_t*m/(sqrt(v)+eps) with eps OUTSIDE the square root, reduced-precision
slots (``slot_dtype``: None, a dtype, or ``{"m": ..., "v": ...}`` with
``BF16_SR`` for stochastically rounded bf16), a bf16 master parameter updated
in fp32 and rounded stochastically, and ``fused_leaves`` that route a [V, W]
leaf to the one-sweep kernel (``ops/fused_adam``: the CUDA kernel on the card,
its plain version on the CPU). ``torch.optim`` does not reproduce these
semantics and is not used.

Interface: ``opt.init(params)`` -> state ``{"m": {key: t}, "v": {key: t},
"t": int32 scalar}``; ``opt.update(grads, state, params)`` updates the
parameter tensors and the state in place. ``params`` and ``grads`` are flat
dicts keyed by rectpu's tree paths (``"table"``, ``"mlp/0/kernel"``), so
``fused_leaves`` names top-level leaves as rectpu's does.

The tree-map update mirrors JAX's type rules where they differ from
PyTorch's: a Python float meets a bf16 array in bf16 (JAX's weak types), and
a 0-d fp32 ``lr_t`` promotes a bf16 slot to fp32. The other optimizers of
rectpu's registry (Adagrad, Ftrl, RMSProp, SGD) are not ported yet (ROADMAP.md
queue A5).
"""

from __future__ import annotations

import torch

from rectpu_torch.ops.fused_adam import adam_lr_t, fused_adam_table, stochastic_round_bf16

__all__ = ["BF16_SR", "Adam", "adam", "get_optimizer", "stochastic_round_bf16"]

BF16_SR = "bfloat16_sr"  # slot-dtype token: bf16 storage with stochastic rounding


def _weak(c: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as JAX's weak type: it takes the array's dtype. (A
    fill, not a host-to-device copy, so the step does not wait for the card.)"""
    return torch.full((), c, dtype=like.dtype, device=like.device)


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
    def _down(x, dt, t, orig_dtype):
        if dt == BF16_SR:
            return stochastic_round_bf16(x, t)
        if dt is None:
            # slots follow the param dtype: the fp32 slot math must not widen a bf16 slot
            return x.to(orig_dtype)
        return x.to(dt)

    def _fusable(self, key: str, p: torch.Tensor) -> bool:
        return key in self.fused_leaves and p.dim() == 2

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> None:
        t = int(state["t"]) + 1
        # fp32 value as a Python float: it multiplies an fp32 tensor exactly as
        # the 0-d fp32 array does in rectpu, with no copy to the card
        lr_t = float(adam_lr_t(t, self.learning_rate, self.beta1, self.beta2))
        for key, p in params.items():
            g = grads[key]
            m, v = state["m"][key], state["v"][key]
            if self._fusable(key, p):
                out = fused_adam_table(
                    p.detach(), m, v, g.contiguous(), t, lr=self.learning_rate,
                    beta1=self.beta1, beta2=self.beta2, eps=self.epsilon,
                    m_sr=self.m_dtype == BF16_SR, v_sr=self.v_dtype == BF16_SR)
            else:
                out = self._leaf_update(p.detach(), m, v, g, t, lr_t)
            for dst, src in zip((p, m, v), out):
                if src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)
        state["t"] = torch.tensor(t, dtype=torch.int32)

    def _leaf_update(self, p, m, v, g, t, lr_t):
        """One leaf of rectpu's ``_treemap_update`` (optimizers.py:192-224)."""
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        g32 = g.float()
        mu, vu = self._up(m, self.m_dtype), self._up(v, self.v_dtype)
        m_new = self._down(_weak(b1, mu) * mu + (1 - b1) * g32, self.m_dtype, t, m.dtype)
        v_new = self._down(_weak(b2, vu) * vu + (1 - b2) * g32 * g32, self.v_dtype, t,
                           v.dtype)
        mu, vu = self._up(m_new, self.m_dtype), self._up(v_new, self.v_dtype)
        upd = lr_t * mu.float() / (torch.sqrt(vu) + _weak(eps, vu))
        if p.dtype == torch.bfloat16:
            # bf16 master: fp32 update math, stochastically rounded, seeded
            # away from the slots' draws
            p_new = stochastic_round_bf16(p.float() - upd, t + (1 << 30))
        else:
            p_new = p - upd
        return p_new, m_new, v_new


def adam(learning_rate: float = 0.001, beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-8, slot_dtype=None, fused_leaves: tuple = ()) -> Adam:
    return Adam(learning_rate, beta1, beta2, epsilon, slot_dtype, fused_leaves)


_NOT_PORTED = ("Adagrad", "Ftrl", "RMSProp", "SGD")


def get_optimizer(optimizer_name: str = "Adam", learning_rate: float = 0.001,
                  slot_dtype=None) -> Adam:
    """Name-based factory (ref trainers/model_utils.py:57-66); Adam only."""
    if optimizer_name == "Adam":
        return adam(learning_rate=learning_rate, slot_dtype=slot_dtype)
    if optimizer_name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {optimizer_name!r} is not ported to rectpu_torch yet "
            "(ROADMAP.md queue A5); only 'Adam' is")
    raise KeyError(optimizer_name)
