"""Posterior-predictive serving: BMA over particles and continuous-batching
BMA decode over a paged KV pool."""
from .batcher import DecodeScheduler, Generation
from .engine import PagedDecodeEngine, PredictiveEngine
from .paging import PagePool, create_kv_pages
from .service import DecodeService, PredictiveService, serve, serve_decode

__all__ = ["DecodeScheduler", "Generation", "PagedDecodeEngine",
           "PredictiveEngine", "PagePool", "create_kv_pages",
           "DecodeService", "PredictiveService", "serve", "serve_decode"]
