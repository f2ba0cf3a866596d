"""Paged serving over the policy-tiered KV cache (``serve/engine.py``)."""
from .engine import PagedLMConfig, Request, ServingEngine

__all__ = ["PagedLMConfig", "Request", "ServingEngine"]
