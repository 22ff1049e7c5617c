"""Serving: the drain and the continuous-batching transcription servers."""

from .server import ContinuousTranscriptionServer, ServerStats, TranscriptionServer

__all__ = [
    "TranscriptionServer",
    "ContinuousTranscriptionServer",
    "ServerStats",
]
