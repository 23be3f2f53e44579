"""Launch helpers: the tensor-parallel serving mesh (``mesh.py``)."""
