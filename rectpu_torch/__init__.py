"""rectpu_torch: the PyTorch + CUDA port of rectpu for NVIDIA Hopper.

The package mirrors ``rectpu/``'s layout module for module, so each piece has
an obvious counterpart in the JAX reference. It imports ``torch`` and numpy
only: never ``jax`` and never anything of ``rectpu`` (it keeps its own copy of
the few pure-Python modules it needs, such as the FarmHash and the feature
schema, and of rectpu's C++ host library, ``io/native``).

Entry points (``serve.export.load_model``, ``serve.export.ServingModel``,
``python -m rectpu_torch.serve.server``, ``python -m
rectpu_torch.serve.batch_predict``, ``python -m
rectpu_torch.trainers.deep_fm``) run on ``cuda`` unless the caller passes
``device="cpu"`` (``--device cpu``); without a GPU and without that explicit
request they raise (``rectpu_torch.device.resolve_device``).
"""

from rectpu_torch.device import resolve_device

__all__ = ["resolve_device"]
