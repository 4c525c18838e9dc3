"""Posterior-predictive serving: BMA over particles, continuous-batching
BMA decode over a paged KV pool (plain or speculative), and stateful
decode over dense KV caches."""
from .batcher import DecodeScheduler, Generation
from .engine import PagedDecodeEngine, PredictiveEngine
from .paging import PagePool, create_kv_pages
from .service import DecodeService, PredictiveService, serve, serve_decode
from .speculative import (SpecConfig, SpecDecodeEngine,
                          SpeculativeDecodeScheduler)

__all__ = ["DecodeScheduler", "Generation", "PagedDecodeEngine",
           "PredictiveEngine", "PagePool", "create_kv_pages",
           "DecodeService", "PredictiveService", "serve", "serve_decode",
           "SpecConfig", "SpecDecodeEngine", "SpeculativeDecodeScheduler"]
