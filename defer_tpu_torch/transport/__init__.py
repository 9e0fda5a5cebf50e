from .replay import ReplayBuffer

__all__ = ["ReplayBuffer"]
