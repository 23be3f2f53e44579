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
``core/vm.py`` (copy)                   ``repro/core/vm.py`` (the mmap arena,
                                        ``ReleaseStrategy``,
                                        ``superblock_floor``)
``core/sizeclass.py``, ``atomic.py``,   ``repro/core/`` same names (the host
``lrmalloc.py``, ``reclaim.py``,        layer: LRMalloc with ``palloc``,
``datastructures.py`` (copies)          ``HostAllocator``, the reclaimers,
                                        the lock-free list and hash table)
``core/allocator.py`` (copy)            ``repro/core/allocator.py``
``core/reclaim_policy.py`` (copy)       ``repro/core/reclaim_policy.py``
``core/chaos.py``                       ``repro/core/chaos.py`` (snapshot's
                                        bump a device op)
``core/pagepool.py``                    ``repro/core/pagepool.py`` (the pool
                                        state and ``DevicePagePool``)
``core/pagepool.py``'s public           ``repro/core/pagepool.py``'s 13
functions (``alloc_pages_batch`` ...    public functions (each returns a
``gather_kv``)                          new pool: nothing is donated)
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
``models/graphs.py``                    ``jax.jit(model.decode_step,
(``graph_decode_step``)                 donate_argnums=1)``: one captured
                                        CUDA graph a key on a card
``capture.py``                          (the capture rule, stream and
                                        recording shared by the runner's
                                        and the decode step's graphs)
``optim/adamw.py``                      ``repro/optim/adamw.py`` (state by
                                        parameter name, updated in place;
                                        on DTensors ZeRO-1's moments)
``data/pipeline.py`` (copy)             ``repro/data/pipeline.py``
``checkpoint/manager.py``               ``repro/checkpoint/manager.py`` (the
                                        same on-disk format; ``device=``,
                                        and ``shardings=`` onto any mesh)
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
                                        abstract; ``make_device_mesh``,
                                        ``init_distributed``,
                                        ``mesh_context``)
``launch/abstract.py``                  ``jax.eval_shape``: fake tensors
                                        (``FakeTensorMode``); a fake
                                        process group for the dry run
``launch/op_analysis.py``               ``repro/launch/hlo_analysis.py``
                                        (counts the eager step's aten ops
                                        and collectives, a device's share)
``launch/roofline.py``                  ``repro/launch/roofline.py`` (H100
                                        spec-sheet rates)
``launch/dryrun.py``                    ``repro/launch/dryrun.py`` (exact
                                        argument bytes, the sharded step
                                        counted on a fake process group;
                                        no temporaries)
``launch/serve.py``                     ``repro/launch/serve.py`` (plus
                                        ``--device``)
``launch/steps.py``                     ``repro/launch/steps.py``, and
                                        ``sharded``: ``jax.jit(step,
                                        in_shardings=, out_shardings=)``
``launch/train.py``                     ``repro/launch/train.py`` (plus
                                        ``--device``; no ``--mesh``)
``sharding/rules.py``                   ``repro/sharding/rules.py``
                                        (``param_specs``, ``opt_specs``,
                                        ``batch_specs``, ``cache_specs``,
                                        ``to_named`` as ``to_placed``, the
                                        annotations as DTensor
                                        redistributions, and the serving
                                        cut read off the specs: every
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

The sharded step is the reference's GSPMD program run eagerly on
DTensors: every rank of a ``torch.distributed`` ``DeviceMesh`` runs the
same step (``launch/steps.py::sharded``), the specs place its arguments,
the annotations (``constrain``, ``shard_seq``, ``shard_logits``,
``shard_experts``) redistribute under ``launch/mesh.py::mesh_context``,
and the regions DTensor has no rule for run on each rank's shards
(``sharding/rules.py::local``).  The serving engine's tensor parallelism
stays the single-controller cut (one host thread, a shard a device).
No counterpart: ``launch/mesh.py``'s ``_make_mesh`` (a jax-version shim);
the dry run's ``--save-hlo`` has no HLO to save.
``tests/test_torch_api.py`` holds every public name of ``repro`` to a
counterpart here, with the names that differ by design listed there.
"""
