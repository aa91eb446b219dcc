"""Serving: paged KV cache, DSG serving runtime, engine, workloads."""
