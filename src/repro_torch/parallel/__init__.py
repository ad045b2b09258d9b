"""Distributed-training pieces of the port (``repro.parallel``'s
counterpart). On one card only gradient compression applies; sharding and
pipelining come with the multi-card slice (ROADMAP)."""
