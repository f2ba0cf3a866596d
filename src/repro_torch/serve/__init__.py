"""Serving: paged serving over the policy-tiered KV cache
(``serve/engine.py``) and the model zoo's prefill and decode steps
(``serve/serve_step.py``)."""
from .engine import PagedLMConfig, Request, ServingEngine
from .serve_step import make_prefill, make_serve_step

__all__ = ["PagedLMConfig", "Request", "ServingEngine", "make_prefill",
           "make_serve_step"]
