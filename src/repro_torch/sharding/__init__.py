"""Sharding rules for tensor-parallel serving: how the dense decoder's
weights and the paged KV arena split over a serving mesh (``rules.py``)."""
