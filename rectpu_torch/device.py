"""Device resolution for the port's entry points.

The port runs on the card by default. Nothing quietly carries on on the CPU:
a request for ``cuda`` (the default) on a machine without a usable GPU
raises, and the CPU is used only when the caller names it.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when ``torch.cuda.is_available()``
    is false. For a CUDA device it also pins the float32 matmul contract the
    JAX reference has on its CPU and in the tests (true float32, no TF32) and
    keeps bf16 matmul reductions in float32: an fp32 export then serves in
    fp32, and a bf16 tower accumulates as ``preferred_element_type=float32``.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rectpu_torch runs on CUDA by default, but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


def device_key(x: torch.Tensor | torch.device | str) -> str:
    """The key of the autotuner's pins for a tensor's or a device's type:
    "cuda" or "cpu" (rectpu keys its pins "tpu" / "other")."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    return "cuda" if dev.type == "cuda" else "cpu"
