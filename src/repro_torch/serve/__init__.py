"""Posterior-predictive serving: BMA over particles with request
coalescing, continuous-batching BMA decode over a paged KV pool (plain or
speculative), stateful decode over dense KV caches, and calibration
metrics."""
from . import metrics, uncertainty
from ..runtime.bucketing import bucket_size, pad_rows
from .batcher import DecodeScheduler, Generation, MicroBatcher
from .engine import PagedDecodeEngine, PredictiveEngine
from .paging import PagePool, create_kv_pages
from .service import (DecodeService, PendingGeneration, PendingPrediction,
                      Prediction, PredictiveService, serve, serve_decode)
from .speculative import (SpecConfig, SpecDecodeEngine,
                          SpeculativeDecodeScheduler)

__all__ = ["DecodeScheduler", "Generation", "MicroBatcher",
           "PagedDecodeEngine", "PredictiveEngine", "PagePool",
           "create_kv_pages", "DecodeService", "PendingGeneration",
           "PendingPrediction",
           "Prediction", "PredictiveService", "serve", "serve_decode",
           "SpecConfig", "SpecDecodeEngine", "SpeculativeDecodeScheduler",
           "bucket_size", "metrics", "pad_rows", "uncertainty"]
