"""The reference's first training steps, in plain PyTorch.

``reference_run`` makes the start values again from the seed (``weights``),
keeps of each table leaf only the rows that the first steps' batches touch
(a row no batch touches has a zero gradient, so plain SGD and Adam leave it
where it started: it adds nothing to any norm below), and runs the steps
with autograd and the optimizer's update as TensorFlow defines it. It
returns each step's loss, each leaf's first gradient norm (read as the
program's is) and each leaf's change after the steps, in float64.

The control is the same reference with every matrix product in TF32: both
operands rounded to 10 mantissa bits (round to nearest even), products
summed in float32, which is what a TF32 tensor core does. Emulated, so that
the control reads the same on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import weights


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with every product's operands in TF32, the backward's too."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ar, br)
        return torch.matmul(ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = tf32_round(g)
        ga = torch.matmul(gr, br.transpose(-1, -2))
        gb = torch.matmul(ar.transpose(-1, -2), gr)
        if gb.dim() > br.dim():  # a batched a against one b
            gb = gb.sum(dim=tuple(range(gb.dim() - br.dim())))
        return ga, gb


def _mm_fp32(a, b):
    return torch.matmul(a, b)


def _mm_tf32(a, b):
    return _TF32MatMul.apply(a, b)


def mm_for(precision: str):
    return {"fp32": _mm_fp32, "tf32": _mm_tf32}[precision]


def no_tf32() -> None:
    """float32 matrix products in float32 on the card as well."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def norms(leaves: dict, union: torch.Tensor, shards: dict | None) -> dict:
    """{leaf: float64 norm}; a table leaf that ``shards`` splits ({leaf:
    [(first row, end row) of rank r]}) gives one norm a rank, "leaf@r", of
    the rows of ``union`` (its rows' global ids) in that rank's range."""
    out = {}
    for k, v in leaves.items():
        if shards and k in shards:
            for r, (lo, hi) in enumerate(shards[k]):
                sel = (union >= lo) & (union < hi)
                out[f"{k}@{r}"] = float(v[sel].double().norm())
        else:
            out[k] = float(v.double().norm())
    return out


@torch.no_grad()
def first_grad_norms(optimizer: dict, grads, m1: dict, union, shards) -> dict:
    """Each leaf's first gradient as the program's is read: Adam's from its
    state after one step (m / (1 - beta1)), SGD's as the update got it."""
    if optimizer["name"] == "Adam":
        scale = 1 / (1 - float(optimizer["beta1"]))
        return {k: v * scale for k, v in norms(m1, union, shards).items()}
    return norms(dict(zip(m1, grads)), union, shards)


def reference_run(ref, conf: dict, specs: dict, seed: int, batches: list, optimizer: dict,
                  precision: str = "fp32", half_batch: bool = False,
                  shards: dict | None = None) -> dict:
    """``batches``: [(ids [B, F] global rows, dense [B, D], labels [B])] on
    one device. ``optimizer``: {"name": "SGD" | "Adam", "learning_rate",
    "beta1", "beta2", "epsilon"}. ``half_batch`` plants a fault: each
    step's loss is the mean over the first half of its batch only.
    ``shards`` reads a row-sharded table leaf's norms a rank (``norms``)."""
    no_tf32()
    device = batches[0][0].device
    mm = mm_for(precision)
    union = torch.unique(torch.cat([b[0].reshape(-1) for b in batches]).long())
    p0 = {}
    for key, spec in specs.items():
        if key in ref.TABLE_LEAVES:
            p0[key] = weights.rows_of(spec, key, seed, union, device)
        else:
            p0[key] = weights.make_leaf(spec, key, seed, device)
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p0.items()}
    losses, grad_norms = [], None
    lr = float(optimizer["learning_rate"])
    for t, (ids, dense, labels) in enumerate(batches, start=1):
        local = torch.searchsorted(union, ids.long())
        if half_batch:
            h = ids.shape[0] // 2
            local, dense, labels = local[:h], dense[:h], labels[:h]
        logit = ref.logits(conf, p, local, dense, mm)
        loss = F.binary_cross_entropy_with_logits(logit, labels)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                if optimizer["name"] == "SGD":
                    w -= lr * g
                elif optimizer["name"] == "Adam":
                    b1, b2 = float(optimizer["beta1"]), float(optimizer["beta2"])
                    m[k].mul_(b1).add_((1 - b1) * g)
                    v2[k].mul_(b2).add_((1 - b2) * g * g)
                    lr_t = lr * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t)
                    w -= lr_t * m[k] / (v2[k].sqrt() + float(optimizer["epsilon"]))
                else:
                    raise ValueError(f"no reference update for {optimizer['name']}")
        if grad_norms is None:
            grad_norms = first_grad_norms(optimizer, grads, m, union, shards)
    changes = norms({k: p[k].detach() - p0[k] for k in p}, union, shards)
    return {"losses": losses, "grad_norms": grad_norms, "changes": changes}
