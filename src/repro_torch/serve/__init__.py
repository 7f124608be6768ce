from .engine import Completion, Request, ServeEngine

__all__ = ["ServeEngine", "Request", "Completion"]
