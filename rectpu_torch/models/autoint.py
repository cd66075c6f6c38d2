"""AutoInt: the port of ``rectpu/models/autoint.py`` (Song et al., arXiv:1810.11921).

    x        = per-field embeddings                      [B, M, K]
    per layer, per head i:
      q, k, v = x Wq_i, x Wk_i, x Wv_i                   [B, M, E]
      att     = softmax_over_fields(q k^T / sqrt(E)) v   [B, M, E]
    x'       = relu(concat_i att + x Wres)               (residual)
    logit    = linear + w . flatten(x_L)

The weights are ``nn.Parameter``s named after rectpu's leaves: ``table``
(packed [V, K+1(+pad)]) or ``emb`` [V, K], ``linear.w`` / ``linear.b`` /
``linear.w_num``, ``num_emb`` [1, N, K], ``att.<i>.{wq,wk,wv,wres}``
[Din, H*E] (Din = K for the first layer, H*E after it) and ``out.w``
[M*H*E, 1], ``out.b`` [1]. Adam(1e-3) by default; AutoInt has no dropout.

Each layer projects q, k and v with one fused [Din, 3D] matmul, as rectpu
does (``autoint.py:167-173``: each output column is the same dot product
either way). The attention follows ``att_impl``:

  - "broadcast" and "bf16": rectpu writes both products as broadcast
    multiplies and sums (``:183-198``), which XLA fuses; in eager PyTorch that
    form would materialise [B, M, M, H, E]. The port computes them as fp32
    einsums of the operands, no such tensor formed. The logits are fp32 in
    both forms and the softmax output is rounded to x's dtype before its
    product with v, whose sum is rounded to x's dtype. Under a bf16 compute
    dtype rectpu's graph multiplies in bf16 and converts to fp32 before the
    sum; XLA on the CPU, where the port is held to rectpu, keeps those
    products exact (its excess precision removes the bf16 round trip), which
    is what an fp32 einsum of bf16 values computes. So the two forms are the
    same function in the port, up to the order of the sums.
  - "grouped" (``_grouped_field_attention``, ``:43-68``): ``att_group``
    examples' fields in one [g*M, g*M] attention with a block-diagonal mask;
    the masked logits softmax to exactly 0. As in rectpu, a batch that
    ``att_group`` does not divide falls back to the broadcast form
    (``:174``).

The linear tower comes in rectpu's three forms: unfused (its own gather of
``linear.w``), fused (one gather of ``[emb | linear.w]``, assembled per call)
and packed (``packed_linear``: that table is the parameter ``table``).
rectpu's flat layout (packed, no numeric fields) reads the packed table
through ``lookup_flat``, a TPU layout that takes no lane-padded table; the
port computes the same values from the [B, F, K+1] gather and raises for a
padded table as rectpu does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rectpu_torch.models.base import (
    RecModel,
    TowerConfig,
    _dot,
    glorot_uniform,
    init_embedding_table,
    init_linear_tower,
    linear_tower_logit,
    lookup_fields,
    pack_fused_table,
    truncated_normal,
)
from rectpu_torch.models.dnn import append_numeric

ATT_IMPLS = ("broadcast", "bf16", "grouped")


def _sqrt(dh: int, device) -> torch.Tensor:
    """sqrt(dh) in fp32, as rectpu's ``jnp.sqrt(jnp.float32(dh))``. (A fill,
    not a host-to-device copy, so a CUDA graph can capture it.)"""
    return torch.sqrt(torch.full((), float(dh), dtype=torch.float32, device=device))


def grouped_field_attention(q, k, v, g: int) -> torch.Tensor:
    """rectpu's ``_grouped_field_attention``: [B, M, H, E] -> [B, M, H, E],
    ``g`` examples' fields in one block-diagonal [g*M, g*M] attention; fp32
    logits and softmax, products of the operands summed in fp32."""
    b, m, nh, dh = q.shape
    gm = g * m
    qg, kg, vg = (t.reshape(b // g, gm, nh, dh).float() for t in (q, k, v))
    logits = torch.einsum("bihd,bjhd->bhij", qg, kg)
    blk = torch.arange(gm, device=q.device) // m
    mask = blk[:, None] == blk[None, :]
    logits = torch.where(mask, logits / _sqrt(dh, q.device),
                         torch.full((), float("-inf"), device=q.device))
    att = torch.softmax(logits, dim=3).to(q.dtype)
    out = torch.einsum("bhij,bjhd->bihd", att.float(), vg).to(q.dtype)
    return out.reshape(b, m, nh, dh)


def field_attention(q, k, v) -> torch.Tensor:
    """The "broadcast" and "bf16" forms: [B, M, H, E] -> [B, M, H, E] with
    fp32 logits, the softmax over the attended fields rounded to q's dtype,
    and its product with v summed in fp32 and rounded to q's dtype (see the
    module docstring). rectpu's logits are [B, M, N, H] with the softmax over
    N; the port keeps N last ([B, M, H, N]), so the softmax runs along
    contiguous rows (a softmax over a middle axis took 1.5 ms of a 12 ms
    AutoInt zoo step on an H100)."""
    dh = q.shape[-1]
    logits = torch.einsum("bmhe,bnhe->bmhn", q.float(), k.float())
    att = torch.softmax(logits / _sqrt(dh, q.device), dim=-1).to(q.dtype)
    return torch.einsum("bmhn,bnhe->bmhe", att.float(), v.float()).to(q.dtype)


class AutoIntModel(RecModel):
    name = "autoint"
    EXPORT_KWARGS = ("use_linear", "num_layers", "num_heads", "head_dim", "att_impl",
                     "att_group")

    def __init__(self, cfg: TowerConfig, use_linear: bool = True, num_layers: int = 2,
                 num_heads: int = 2, head_dim: int | None = None,
                 att_impl: str = "broadcast", att_group: int = 8):
        super().__init__()
        if cfg.num_fields + cfg.num_numeric == 0:
            raise ValueError("AutoInt needs at least one feature column")
        if num_layers < 1 or num_heads < 1:
            raise ValueError("num_layers and num_heads must be >= 1")
        if att_impl not in ATT_IMPLS:
            raise ValueError(f"att_impl must be broadcast|bf16|grouped, got {att_impl}")
        self.cfg = cfg
        self.use_linear = use_linear
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = (int(head_dim) if head_dim is not None
                         else max(cfg.embedding_size // num_heads, 1))
        self.att_impl = att_impl
        self.att_group = int(att_group)

    @property
    def packed(self) -> bool:
        return self.cfg.packed_linear and self.cfg.fuse_linear_lookup and self.use_linear

    @property
    def fused(self) -> bool:
        """The linear weight rides the embedding gather as column K."""
        return self.use_linear and self.cfg.fuse_linear_lookup

    @property
    def m(self) -> int:
        return self.cfg.num_fields + self.cfg.num_numeric

    @property
    def d_model(self) -> int:
        return self.num_heads * self.head_dim

    def init(self, generator: torch.Generator) -> dict:
        """A fresh tree in rectpu's layout: zero linear tower, a
        truncated-normal table (stddev 1/sqrt(K)), glorot-uniform projections
        and output weight, a zero output bias."""
        cfg, k, d = self.cfg, self.cfg.embedding_size, self.d_model
        params = {}
        if self.use_linear:
            params["linear"] = init_linear_tower(cfg)
        emb = init_embedding_table(generator, cfg)
        if self.packed:
            params["table"] = pack_fused_table(emb, params["linear"].pop("w"),
                                               cfg.packed_col_pad)
        else:
            params["emb"] = emb
        if cfg.num_numeric:
            params["num_emb"] = truncated_normal(generator, (1, cfg.num_numeric, k), k ** -0.5)
        layers, d_in = [], k
        for _ in range(self.num_layers):
            layers.append({name: glorot_uniform(generator, (d_in, d))
                           for name in ("wq", "wk", "wv", "wres")})
            d_in = d
        params["att"] = layers
        params["out"] = {"w": glorot_uniform(generator, (self.m * d, 1)), "b": torch.zeros(1)}
        return params

    def _interacting_layer(self, layer, x: torch.Tensor) -> torch.Tensor:
        """x [B, M, Din] -> relu(multi-head attention + residual) [B, M, D]."""
        nh, dh = self.num_heads, self.head_dim
        b, m, _ = x.shape
        d = nh * dh
        wqkv = torch.cat([layer["wq"], layer["wk"], layer["wv"]], dim=1).to(x.dtype)
        qkv = _dot(x, wqkv, x.dtype)
        q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, m, nh, dh) for i in range(3))
        if self.att_impl == "grouped" and b % self.att_group == 0:
            out = grouped_field_attention(q, k, v, self.att_group)
        else:
            out = field_attention(q, k, v)
        res = _dot(x, layer["wres"].to(x.dtype), x.dtype)
        return F.relu(out.reshape(b, m, d) + res)

    def _att_logit(self, emb: torch.Tensor) -> torch.Tensor:
        x = emb
        for layer in self.att:
            x = self._interacting_layer(layer, x)
        flat = x.reshape(x.shape[0], -1).float()
        return (flat @ self.out["w"].float() + self.out["b"].float())[:, 0]

    def forward(self, cat_ids: torch.Tensor, num_vals: torch.Tensor | None = None, *,
                train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """cat_ids [B, F] int32 global row ids, num_vals [B, N] -> logits [B]
        fp32 (AutoInt has no dropout: ``train`` and ``seed32`` change nothing)."""
        cfg = self.cfg
        k = cfg.embedding_size
        if cfg.flat_layout and self.packed and cfg.num_numeric == 0:
            if self.table.shape[1] > k + 1:
                raise NotImplementedError(
                    f"the flat layout does not take a lane-padded packed table (width "
                    f"{self.table.shape[1]} > K+1={k + 1}), as rectpu's lookup_flat does not")
            emb, lin = self.flat_lookup(self.table, cat_ids, has_lin=True)
            return lin + self.linear["b"] + self._att_logit(emb)
        logits = torch.zeros(cat_ids.shape[0], dtype=torch.float32, device=cat_ids.device)
        if self.use_linear and not self.fused:
            logits = logits + linear_tower_logit(self.linear, cat_ids, num_vals,
                                                 cfg.embedding_impl)
        table = (self.table if self.packed
                 else self.ep_table(self.emb, self.linear["w"]) if self.fused else self.emb)
        looked = lookup_fields(table, cat_ids, cfg, self.lookup_fn)
        return logits + self.apply_looked(looked, num_vals)

    def apply_looked(self, looked: torch.Tensor, num_vals: torch.Tensor | None, *,
                     train: bool = False, seed32: int | None = None) -> torch.Tensor:
        """Tower math from gathered rows ([B, F, K+1(+pad)] when the linear
        tower is fused, else [B, F, K]): the sparse fast step's hook."""
        cfg = self.cfg
        k = cfg.embedding_size
        logits = torch.zeros(looked.shape[0], dtype=torch.float32, device=looked.device)
        emb = looked
        if self.fused:
            emb = looked[..., :k]
            logits = logits + looked[..., k].float().sum(dim=-1) + self.linear["b"]
            if "w_num" in self.linear and num_vals is not None:
                logits = logits + num_vals.float() @ self.linear["w_num"]
        emb = append_numeric(self, emb, num_vals)
        if cfg.torch_compute_dtype is not None:
            emb = emb.to(cfg.torch_compute_dtype)
        return logits + self._att_logit(emb)

    def default_optimizer(self):
        """Adam(1e-3), the zoo's deep-model convention."""
        from rectpu_torch.train.optimizers import adam

        return adam(learning_rate=0.001)
