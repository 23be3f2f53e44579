"""Launch helpers: the tensor-parallel serving mesh (``mesh.py``) and the
serving CLI (``serve.py``)."""
