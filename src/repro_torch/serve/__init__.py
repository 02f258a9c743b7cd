from .scheduler import Request, Result, ServeLoop

__all__ = ["Request", "Result", "ServeLoop"]
