from rectpu_torch.models.base import TowerConfig
from rectpu_torch.models.deep_fm import DeepFMModel

# rectpu's other families, still to port (ROADMAP.md queue A)
_NOT_PORTED = ("linear", "deep", "linear_deep", "dlrm", "dcn", "xdeep_fm", "autoint")


class _Registry(dict):
    def __missing__(self, name):
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"model family {name!r} is not ported to rectpu_torch yet "
                "(ROADMAP.md queue A); only 'deep_fm' is")
        raise KeyError(name)


MODEL_REGISTRY = _Registry(deep_fm=DeepFMModel)

__all__ = ["TowerConfig", "DeepFMModel", "MODEL_REGISTRY"]
