"""Distributed-training pieces of the port (``repro.parallel``'s
counterpart): the sharding rules and ``shard`` hook (``sharding``), the
GPipe schedule (``pipeline``) and int8 gradient compression
(``compression``)."""
