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
``core/chaos.py``                       ``repro/core/chaos.py`` (snapshot's
                                        bump a device op)
``core/pagepool.py``                    ``repro/core/pagepool.py``
``models/layers.py``                    ``repro/models/layers.py`` (norms,
                                        RoPE, QKV, MLPs, flash attention
                                        forward, decode attention)
``models/moe.py``                       ``repro/models/moe.py`` (forward:
                                        routing, capacity, dropless)
``models/rglru.py``, ``models/ssm.py``  ``repro/models/`` same names
``models/transformer.py``               ``repro/models/transformer.py``
                                        (inference: every family's
                                        forward, prefill, decode step and
                                        cache; ``DecoderLM``, ``EncDecLM``,
                                        ``HybridLM``, ``SSMLM``)
``models/model.py``                     ``repro/models/model.py``
                                        (``build_model``, ``Model``; no
                                        ``loss``)
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
``launch/serve.py``                     ``repro/launch/serve.py`` (plus
                                        ``--device``)
``sharding/rules.py``                   ``repro/sharding/rules.py`` (serving
                                        TP subset: weights, experts'
                                        hidden axis, paged arena split or
                                        replicated)
``serving/paged_decode.py``             ``repro/serving/paged_decode.py``
``serving/kv_manager.py``               ``repro/serving/kv_manager.py``
``serving/runner.py``                   ``repro/serving/runner.py``
``serving/scheduler.py`` (copy)         ``repro/serving/scheduler.py``
``serving/stats.py``, ``draft.py``,     ``repro/serving/`` same names
``overload.py``, ``traffic.py``
(copies)
``serving/engine.py``                   ``repro/serving/engine.py``
``serving/parallel.py``                 ``repro/serving/parallel.py`` (one
                                        driver thread per replica, its
                                        device made current)
=====================================  =======================================

"(copy)" modules equal their originals apart from import lines (and
``Request.pages``, which reads a CPU or CUDA block table);
``tests/test_torch_engine.py`` pins that.

Not yet ported: the reference's other MoE layouts (``REPRO_MOE_SHARD`` =
``ep``, ``data``, ``none``); training (``Model.loss``, ``_chunked_ce``,
the flash and MoE backwards, ``optim/``, ``data/``, ``checkpoint/``,
``launch/steps.py``); ``launch/*`` apart from
``make_serving_mesh`` and ``serve.py``; the host arena and lock-free
reclaimers of ``core/`` (``lrmalloc.py``, ``reclaim.py``, …).
"""
