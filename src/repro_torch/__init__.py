"""PyTorch/CUDA port of ``repro`` for an NVIDIA H100 (Hopper, sm_90a).

The port imports ``torch`` and numpy, never jax and nothing of ``repro``;
the JAX package stays the reference, and ``tests/test_torch_*.py`` hold
each module here to its counterpart there on the same inputs.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; with no GPU and
no explicit device they raise (``device.py``).

Module map (port -> JAX counterpart):

=====================================  =======================================
``configs/`` (``base.py``, arch files)  ``repro/configs/`` (``input_specs``
                                        gives fake tensors)
``core/vm.py``                          ``repro/core/vm.py`` (``ReleaseStrategy``
                                        and ``superblock_floor`` only)
``core/allocator.py`` (copy)            ``repro/core/allocator.py``
``core/reclaim_policy.py`` (copy)       ``repro/core/reclaim_policy.py``
``core/chaos.py``                       ``repro/core/chaos.py`` (snapshot's
                                        bump a device op)
``core/pagepool.py``                    ``repro/core/pagepool.py``
``models/layers.py``                    ``repro/models/layers.py`` (norms,
                                        RoPE, QKV, MLPs, flash attention
                                        and its backward, decode
                                        attention)
``models/moe.py``                       ``repro/models/moe.py`` (routing,
                                        capacity, dropless; the backward
                                        is autograd's)
``models/rglru.py``, ``models/ssm.py``  ``repro/models/`` same names
``models/transformer.py``               ``repro/models/transformer.py``
                                        (every family's forward under
                                        ``remat``, prefill, decode step and
                                        cache; ``DecoderLM``, ``EncDecLM``,
                                        ``HybridLM``, ``SSMLM``)
``models/model.py``                     ``repro/models/model.py``
                                        (``build_model``, ``Model`` with
                                        ``loss``)
``optim/adamw.py``                      ``repro/optim/adamw.py`` (state by
                                        parameter name, updated in place)
``data/pipeline.py`` (copy)             ``repro/data/pipeline.py``
``checkpoint/manager.py``               ``repro/checkpoint/manager.py`` (the
                                        same on-disk format; ``device=``
                                        for ``shardings=``)
``convert.py``                          the weight (and AdamW state) bridge
                                        from the JAX pytree
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
                                        (production and smoke meshes
                                        abstract: axis sizes, no devices)
``launch/abstract.py``                  ``jax.eval_shape``: fake tensors
                                        (``FakeTensorMode``)
``launch/op_analysis.py``               ``repro/launch/hlo_analysis.py``
                                        (counts the eager step's aten ops)
``launch/roofline.py``                  ``repro/launch/roofline.py`` (H100
                                        spec-sheet rates)
``launch/dryrun.py``                    ``repro/launch/dryrun.py`` (exact
                                        argument bytes, the op count split
                                        ideally; no temporaries, no
                                        collective term)
``launch/serve.py``                     ``repro/launch/serve.py`` (plus
                                        ``--device``)
``launch/steps.py``                     ``repro/launch/steps.py``
``launch/train.py``                     ``repro/launch/train.py`` (plus
                                        ``--device``; no ``--mesh``)
``sharding/rules.py``                   ``repro/sharding/rules.py``
                                        (``param_specs``, ``opt_specs``,
                                        ``batch_specs``, ``cache_specs``
                                        over an abstract mesh, and the
                                        serving cut read off them: every
                                        ``REPRO_MOE_SHARD`` mode; KV heads
                                        cut by the query slab's heads)
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

No counterpart, by design: the reference's GSPMD annotations
(``sharding/rules.py``'s ``constrain``, ``shard_seq``, ``shard_logits``,
``shard_experts``, ``to_named``) tell XLA's partitioner how to lay out a
jitted program; an eager single-controller port has no partitioner, and
its shards hold the slices they compute with.  ``launch/mesh.py``'s
``_make_mesh`` and ``mesh_context`` are jax-version shims; the dry run's
``--save-hlo`` has no HLO to save.

Not yet ported: a sharded training step (a device mesh with FSDP and TP
over ``torch.distributed``: the dry run's collective term and the
counterpart of ``tests/test_elastic.py``); the host arena and lock-free
reclaimers of ``core/`` (``lrmalloc.py``, ``vm.py``'s arena,
``reclaim.py``, ``atomic.py``, ``datastructures.py``, ``sizeclass.py``:
framework-free, no device code; ROADMAP A).
"""
