from rectpu_torch.models.base import TowerConfig
from rectpu_torch.models.deep_fm import DeepFMModel
from rectpu_torch.models.dlrm import DLRMModel
from rectpu_torch.models.xdeep_fm import XDeepFMModel

# rectpu's other families, still to port (ROADMAP.md queue A)
_NOT_PORTED = ("linear", "deep", "linear_deep", "dcn", "autoint")


class _Registry(dict):
    def __missing__(self, name):
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"model family {name!r} is not ported to rectpu_torch yet "
                f"(ROADMAP.md queue A); ported: {sorted(self)}")
        raise KeyError(name)


MODEL_REGISTRY = _Registry(deep_fm=DeepFMModel, dlrm=DLRMModel, xdeep_fm=XDeepFMModel)

__all__ = ["TowerConfig", "DeepFMModel", "DLRMModel", "XDeepFMModel", "MODEL_REGISTRY"]
