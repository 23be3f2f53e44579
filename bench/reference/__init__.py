"""The benchmark's plain references: float32 PyTorch, no kernel, nothing of
the program; one file a family module points to (``model.py``: ``dense``
and ``moe``)."""
