from .base import RegistrarBase
from .dicom import RegistrarDicom
from .fixed import RegistrarFixed
from .model import RegistrarModel
from .registration import Registration
from .restart import RegistrarRestart

__all__ = [
    "Registration",
    "RegistrarBase",
    "RegistrarDicom",
    "RegistrarFixed",
    "RegistrarModel",
    "RegistrarRestart",
]
