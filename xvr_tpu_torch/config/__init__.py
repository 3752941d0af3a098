from .registrar import RegistrarArgs
from .trainer import TrainerArgs

__all__ = ["RegistrarArgs", "TrainerArgs"]
