"""Serving runtime: the paged KV pool and the slot-table engine."""
