"""Launch helpers: the meshes (``mesh.py``), the step functions
(``steps.py``), the serving CLI (``serve.py``), the training loop
(``train.py``), and the dry-run tools: fake-tensor shapes
(``abstract.py``), the op analysis (``op_analysis.py``), the dry run
(``dryrun.py``) and the roofline (``roofline.py``)."""
