from .registrar import RegistrarArgs

__all__ = ["RegistrarArgs"]
