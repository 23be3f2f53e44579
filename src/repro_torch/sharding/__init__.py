"""Sharding rules for tensor-parallel serving: how a decoder LM's weights
(dense, MoE and the VLM's text decoder) and the paged KV arena split over a
serving mesh (``rules.py``)."""
