from repro_torch.serving.engine import SEEN_SHAPES, Request, ServeEngine

__all__ = ["SEEN_SHAPES", "Request", "ServeEngine"]
