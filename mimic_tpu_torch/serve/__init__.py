from .engine import ServeEngine, ServeRequest, ServeResult

__all__ = ["ServeEngine", "ServeRequest", "ServeResult"]
