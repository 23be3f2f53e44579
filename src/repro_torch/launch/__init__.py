"""Launch helpers: the tensor-parallel serving mesh (``mesh.py``), the
step functions (``steps.py``), the serving CLI (``serve.py``) and the
training driver (``train.py``)."""
