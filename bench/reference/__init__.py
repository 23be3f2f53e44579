"""The benchmark's plain reference: float32 PyTorch, no kernel, nothing of
the program (``model.py``)."""
