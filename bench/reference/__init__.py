"""Plain PyTorch reference of the index's semantics: a sorted key table with
a value per key, searched by binary search over packed key words. It
imports nothing of ``repro_torch`` and takes nothing the program built: it
is given the keys, values and queries the harness made."""
