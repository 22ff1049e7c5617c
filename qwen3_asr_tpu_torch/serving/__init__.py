"""Serving: the drain, continuous-batching and replicated transcription
servers."""

from .server import (
    ContinuousTranscriptionServer,
    ReplicatedTranscriptionServer,
    ServerStats,
    TranscriptionServer,
)

__all__ = [
    "TranscriptionServer",
    "ContinuousTranscriptionServer",
    "ReplicatedTranscriptionServer",
    "ServerStats",
]
