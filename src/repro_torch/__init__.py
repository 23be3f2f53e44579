"""PyTorch/CUDA port of ``repro`` for an NVIDIA H100 (Hopper, sm_90a).

The port imports ``torch`` and numpy, never jax and nothing of ``repro``;
the JAX package stays the reference, and ``tests/test_torch_*.py`` hold
each module here to its counterpart there on the same inputs.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; with no GPU and
no explicit device they raise (``device.py``).

Module map (port -> JAX counterpart):

=====================================  =======================================
``configs/`` (``base.py``, arch files)  ``repro/configs/`` (no ``input_specs``)
``core/vm.py``                          ``repro/core/vm.py`` (``ReleaseStrategy``
                                        and ``superblock_floor`` only)
``core/allocator.py`` (copy)            ``repro/core/allocator.py``
``core/reclaim_policy.py`` (copy)       ``repro/core/reclaim_policy.py``
``core/pagepool.py``                    ``repro/core/pagepool.py``
``models/layers.py``                    ``repro/models/layers.py`` (dense
                                        subset: norms, RoPE, QKV, MLPs)
``models/transformer.py``               ``repro/models/transformer.py``
                                        (embed/unembed, ``DecoderLM``)
``convert.py``                          the weight bridge from the JAX pytree
``kernels/ref.py``                      ``repro/kernels/ref.py``
``kernels/ops.py``                      ``repro/kernels/ops.py`` (dispatch by
                                        device, not by ``impl``)
``kernels/paged_attention.py`` +        ``repro/kernels/paged_attention.py::
``kernels/csrc/paged_attention.cu``     paged_attention_pallas``
``kernels/kv_append.py`` +              ``repro/kernels/kv_append.py::
``kernels/csrc/kv_append.cu``           kv_append_pallas`` (C-token form;
                                        standalone, off the serving path)
``paged_attention_append_cuda``         ``kv_append_pallas`` then
(``kernels/paged_attention.py``,        ``paged_attention_pallas``: on the
the ``.cu``'s append mode)              serving path kernel 2's work runs
                                        inside kernel 1's launch
``kernels/paged_attention.py``          ``repro/kernels/paged_attention.py::
(``paged_attention_sharded``)           paged_attention_sharded`` (kernel 1
                                        launched once per shard)
``kernels/build.py``                    (nvcc build + ctypes load)
``launch/mesh.py``                      ``repro/launch/mesh.py``
                                        (``make_serving_mesh`` only)
``sharding/rules.py``                   ``repro/sharding/rules.py`` (serving
                                        TP subset: weights, paged arena)
``serving/paged_decode.py``             ``repro/serving/paged_decode.py``
``serving/kv_manager.py``               ``repro/serving/kv_manager.py``
``serving/runner.py``                   ``repro/serving/runner.py``
``serving/scheduler.py`` (copy)         ``repro/serving/scheduler.py``
``serving/stats.py``, ``draft.py``,     ``repro/serving/`` same names
``overload.py`` (copies)
``serving/engine.py``                   ``repro/serving/engine.py``
=====================================  =======================================

"(copy)" modules equal their originals apart from import lines (and
``Request.pages``, which reads a CPU or CUDA block table);
``tests/test_torch_engine.py`` pins that.

Not yet ported: ``core/chaos.py``, ``serving/traffic.py`` and
``serving/parallel.py`` (chaos layer, open-loop traffic, data-parallel
fleet, and with it the 2D replica × tensor fleet); the replicated KV arena
for head counts the tensor-parallel degree does not divide; MoE, VLM, SSM,
hybrid and encoder-decoder families; training (``models/model.py``,
``optim/``, ``data/``, ``checkpoint/``); ``launch/*`` apart from
``make_serving_mesh`` (``serve.py --tp`` included); the host arena and
lock-free reclaimers of ``core/`` (``lrmalloc.py``, ``reclaim.py``, …).
"""
