"""Edge serving runtime: KiSS-managed model container pools on the
device."""
from .container import ModelContainer, cache_mb, pytree_mb
from .server import KissServer, RequestStats, ServeResult, UnifiedServer
from .batcher import Batcher, Request

__all__ = ["ModelContainer", "cache_mb", "pytree_mb", "KissServer",
           "RequestStats", "UnifiedServer", "ServeResult", "Batcher",
           "Request"]
