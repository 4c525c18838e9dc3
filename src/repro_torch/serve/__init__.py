"""Continuous-batching BMA decode over a paged KV pool."""
from .batcher import DecodeScheduler, Generation
from .engine import PagedDecodeEngine, PredictiveEngine
from .paging import PagePool, create_kv_pages
from .service import DecodeService, serve_decode

__all__ = ["DecodeScheduler", "Generation", "PagedDecodeEngine",
           "PredictiveEngine", "PagePool", "create_kv_pages",
           "DecodeService", "serve_decode"]
