from .regressor import PoseRegressor, init_pose_regressor, load_model
from .resnet import ResNet, create_backbone

__all__ = ["PoseRegressor", "ResNet", "create_backbone", "init_pose_regressor", "load_model"]
