"""Serving runtime: continuous-batching engine and observability."""
