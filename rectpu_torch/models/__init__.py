from rectpu_torch.models.autoint import AutoIntModel
from rectpu_torch.models.base import TowerConfig
from rectpu_torch.models.dcn import DCNModel
from rectpu_torch.models.deep_fm import DeepFMModel
from rectpu_torch.models.dlrm import DLRMModel
from rectpu_torch.models.dnn import DNNModel
from rectpu_torch.models.linear import LinearModel
from rectpu_torch.models.wide_deep import WideDeepModel
from rectpu_torch.models.xdeep_fm import XDeepFMModel

MODEL_REGISTRY = dict(linear=LinearModel, deep=DNNModel, linear_deep=WideDeepModel,
                      deep_fm=DeepFMModel, dlrm=DLRMModel, xdeep_fm=XDeepFMModel,
                      dcn=DCNModel, autoint=AutoIntModel)

__all__ = ["TowerConfig", "LinearModel", "DNNModel", "WideDeepModel", "DeepFMModel",
           "DLRMModel", "XDeepFMModel", "DCNModel", "AutoIntModel", "MODEL_REGISTRY"]
