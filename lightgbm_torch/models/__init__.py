from .gbdt import GBDTModel, create_boosting
