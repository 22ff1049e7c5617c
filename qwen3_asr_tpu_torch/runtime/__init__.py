"""Generation runtime."""

from .engine import DecodeEngine, EngineStats, SlotRequest
from .generate import Generator

__all__ = ["DecodeEngine", "EngineStats", "Generator", "SlotRequest"]
