from .base import RegistrarBase
from .fixed import RegistrarFixed

__all__ = ["RegistrarBase", "RegistrarFixed"]
