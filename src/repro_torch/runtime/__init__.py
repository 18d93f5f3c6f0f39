"""Serving runtime: the paged KV pool, the slot-table engine, and the
fault-tolerant fleet of engines with its fault injection."""
