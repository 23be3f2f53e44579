"""Token-choice top-k Mixture of Experts with capacity-bounded dispatch.

The port of ``repro.models.moe``, forward and backward.  The
same function: a float32 router, top-k gates renormalised to sum to 1,
each assignment's slot within its expert counted per batch row in
(token, choice) order, assignments past an expert's capacity C dropped,
a swiglu FFN per expert over its C slots, and the kept outputs gathered
back and summed under their gates.  The sequence is processed in groups
of ``MOE_SEQ_CHUNK`` tokens when it is longer than one group and a
multiple of it (the reference's ``lax.scan``; here a Python loop).

Capacity (:func:`moe_capacity`) is ``ceil(group·k·cf / E)`` when training
and ``group·k`` with ``dropless=True``, which every serving path passes:
no assignment is ever dropped, so one-token decode, chunked prefill and
speculative verification compute the same per-token function.

Layout.  The reference scatters into a ``[B, E, C, d]`` buffer and runs
three einsums batched over experts; here the buffer is ``[E, B·C, d]``
with one trash row after it, so each expert's product is one ``bmm``
slice and a dropped assignment is written to the trash row instead of
relying on an out-of-range scatter being dropped (on CUDA an out-of-range
index is a device-side assert).  The gather back clamps the dropped slot
to C − 1 and multiplies by 0, as the reference's clamped gather does.

The backward is autograd's.  The reference writes the combine's
transpose by hand (``_combine_core``) only to keep GSPMD from
all-gathering the batch; the function is the same as autograd's
transpose of the gather back here: a scatter-add of the kept slots'
cotangents into ``out``, zero for the dropped ones (their gathered row is
multiplied by 0).  The dispatch's transpose likewise gathers each kept
assignment's row of the buffer's cotangent and gives a dropped one 0
(the trash row is outside the expert buffer).

Everything here is a plain tensor op on the caller's device with no host
read: no ``.item()``, no boolean-mask indexing, no ``nonzero``.  Ties in
the top-k are broken by the lower expert index, as ``jax.lax.top_k``
breaks them (a stable descending sort).  The expert products are plain
batched matrix products (``torch.bmm``), as the reference leaves its
einsums to XLA: this is not one of the repo's Pallas kernels.

Parameters (per layer): ``w_router`` [d, E] float32 whatever the model's
dtype; ``w_gate``/``w_up`` [E, d, ff] and ``w_down`` [E, ff, d] in the
model's dtype.  Under tensor parallelism (``sharding/rules.py``) each shard
holds the whole router and either an expert-hidden slice of every expert
(``REPRO_MOE_SHARD=tp``) or its own whole experts ``[e0, e0 + E/T)``
(``ep``: ``expert0=e0``, ``w_gate`` [E/T, d, ff]); :func:`moe_apply` over
it gives that shard's partial output, and the partials sum to the whole
layer's output.  Expert-parallel: every shard routes over all E experts,
dispatches only the assignments to its own experts (the rest go to the
trash row) and runs the products of its experts only; capacity and each
assignment's slot are counted over all E, as in the whole layer.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Shard

from repro_torch.sharding import rules
from .layers import _normal

MOE_SEQ_CHUNK = 512


def moe_capacity(cfg, group_len: int, dropless: bool = False) -> int:
    """Slots per expert and batch row for a group of ``group_len`` tokens."""
    if dropless:  # worst case: every assignment routed to one expert
        return group_len * cfg.top_k
    return max(1, int(math.ceil(
        group_len * cfg.top_k * cfg.capacity_factor / cfg.n_experts)))


def init_moe(cfg, gen, dtype=torch.bfloat16, device=None):
    """Seeded expert weights with the reference's shapes and scales; the
    router stays float32."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    std_in, std_out = 0.02, 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "w_router": _normal(gen, (d, E), std_in, torch.float32, device),
        "w_gate": _normal(gen, (E, d, ff), std_in, dtype, device),
        "w_up": _normal(gen, (E, d, ff), std_in, dtype, device),
        "w_down": _normal(gen, (E, ff, d), std_out, dtype, device),
    }


def _route(cfg, x, w_router):
    """Router over x [B, S, d] in float32 -> (probs [B, S, E], gate and
    expert [B, S, k]), ties to the lower expert index."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[..., :cfg.top_k], expert[..., :cfg.top_k]
    return probs, gate / gate.sum(-1, keepdim=True), expert


def _slots(cfg, expert, C: int, El: int, expert0: int):
    """Each assignment's slot within its expert, per batch row, in (token,
    choice) order -> (flat expert ids [B, S*k], one-hot [B, S*k, E] int32,
    slot [B, S*k], this call's expert index, kept mask): slots past the
    capacity ``C`` are dropped, and so (to this call) are assignments to
    experts outside ``[expert0, expert0 + El)``."""
    B, S, k = expert.shape
    E = cfg.n_experts
    experts = torch.arange(E, device=expert.device)
    onehot = (expert.reshape(B, S * k)[..., None] == experts).to(torch.int32)
    flat_e = expert.reshape(B, S * k)
    pos_in_e = torch.gather(torch.cumsum(onehot, dim=1), 2,
                            flat_e[..., None])[..., 0] - 1  # [B, S*k]
    local_e, keep = _kept(flat_e, pos_in_e, C, El, E, expert0)
    return flat_e, onehot, pos_in_e, local_e, keep


def _kept(flat_e, pos_in_e, C, El, E, expert0):
    """(this call's expert index, kept mask) of each assignment."""
    keep = pos_in_e < C
    local_e = flat_e
    if El != E:  # expert parallelism: this call's experts only
        local_e = flat_e - expert0
        keep = keep & (local_e >= 0) & (local_e < El)
    return local_e, keep


def _aux(cfg, probs, counts, S: int):
    """Load-balancing aux loss (Switch/Mixtral style) from the router
    probabilities [B, S, E] and each row's assignment counts [B, E]."""
    ce = counts.mean(dim=0) / (S * cfg.top_k)
    return cfg.n_experts * torch.sum(probs.mean(dim=(0, 1)) * ce)


def _dispatch(x, local_e, pos_in_e, keep, El: int, C: int, k: int):
    """Every kept assignment's token to its own row of [El, B*C, d] (rows
    no assignment takes stay 0); dropped ones to a trash row past it."""
    B, S, d = x.shape
    rows = torch.arange(B, device=x.device)[:, None]
    trash = El * B * C
    dest = torch.where(keep, (local_e * B + rows) * C + pos_in_e, trash)
    src = x[:, :, None, :].expand(B, S, k, d).reshape(B * S * k, d)
    buf = x.new_zeros((trash + 1, d))
    buf.index_copy_(0, dest.reshape(-1), src)
    return buf[:trash].view(El, B * C, d)


def _experts(eb, p):
    """The expert FFN (swiglu) over [El, B*C, d], one batched product per
    weight."""
    h = F.silu(torch.bmm(eb, p["w_gate"])) * torch.bmm(eb, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _combine(out, local_e, pos_in_e, keep, gate, C: int):
    """Gather each assignment's row of ``out`` [El, B*C, d] back (the
    dropped slot clamped into the buffer, then zeroed) and sum under the
    gates [B, S, k] -> [B, S, d]."""
    El, _, d = out.shape
    B, S, k = gate.shape
    out = out.reshape(-1, d)
    local_e = torch.clamp(local_e, 0, El - 1)
    rows = torch.arange(B, device=out.device)[:, None]
    src_row = (local_e * B + rows) * C + torch.clamp(pos_in_e, max=C - 1)
    gath = out[src_row.reshape(-1)].reshape(B, S * k, d)
    gath = gath * keep[..., None].to(gath.dtype)
    gath = gath * gate.reshape(B, S * k, 1).to(gath.dtype)
    return gath.reshape(B, S, k, d).sum(dim=2)


def _moe_group(cfg, x, p, dropless: bool = False, expert0: int = 0):
    """One token group.  x [B, S, d] -> (y [B, S, d], aux float32 []); the
    products of experts ``[expert0, expert0 + p["w_gate"].shape[0])``.
    Under a mesh: :func:`_moe_group_sharded`."""
    if rules.sharded_on_mesh(x):
        return _moe_group_sharded(cfg, x, p, dropless)
    B, S, d = x.shape
    k = cfg.top_k
    El = p["w_gate"].shape[0]
    C = moe_capacity(cfg, S, dropless=dropless)
    probs, gate, expert = _route(cfg, x, p["w_router"])
    flat_e, onehot, pos_in_e, local_e, keep = _slots(cfg, expert, C, El,
                                                     expert0)
    aux = _aux(cfg, probs, onehot.float().sum(dim=1), S)
    eb = _dispatch(x, local_e, pos_in_e, keep, El, C, k)
    out = _experts(eb, p)
    return _combine(out, local_e, pos_in_e, keep, gate, C), aux


def _moe_group_sharded(cfg, x, p, dropless: bool):
    """:func:`_moe_group` on DTensors, the reference's layout: the group's
    input sequence-parallel (``shard_seq``); routing, slots and the
    dispatch on each rank's batch rows (the slots count over whole rows);
    the buffer [E, B*C, d] batch over the data axes and experts replicated
    (``shard_experts``); the expert products as DTensor batched products
    over the weights' own placements (each expert's hidden slice: partial
    sums over 'model'; whole experts with ``ep``); the combine on each
    rank's rows and experts, partial where the products were."""
    x = rules.shard_seq(x)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, S, dropless=dropless)

    def dispatch(x, w_router):
        probs, gate, expert = _route(cfg, x, w_router)
        flat_e, onehot, pos_in_e, local_e, keep = _slots(cfg, expert, C, E, 0)
        eb = _dispatch(x, local_e, pos_in_e, keep, E, C, k)
        return probs, gate, flat_e, pos_in_e, onehot.float().sum(dim=1), eb

    bs = rules.batch_spec(x)
    dp = bs[0]
    probs, gate, flat_e, pos_in_e, counts, eb = rules.local(
        dispatch, (x, p["w_router"]), (bs, (None, None)),
        [bs, bs, (dp, None), (dp, None), (dp, None), (None, dp, None)])
    aux = _aux(cfg, probs, counts, S)
    out = _experts(rules.shard_experts(eb, expert_axis=0, batch_axis=1), p)

    mesh = rules.current_mesh()
    at = out.placements[mesh.mesh_dim_names.index("model")]
    partial = isinstance(at, Partial)
    ep = isinstance(at, Shard) and at.dim == 0
    out_pl = rules.placements(("model" if ep else None, dp, None), mesh,
                              partial=("model",) if partial else ())

    def combine(out, flat_e, pos_in_e, gate):
        El = out.shape[0]
        expert0 = rules.model_rank() * El if ep else 0
        local_e, keep = _kept(flat_e, pos_in_e, C, El, E, expert0)
        return _combine(out, local_e, pos_in_e, keep, gate, C)

    y = rules.local(combine, (out, flat_e, pos_in_e, gate),
                    (out_pl, (dp, None), (dp, None), bs),
                    rules.placements(bs, mesh, partial=(
                        ("model",) if partial or ep else ())))
    return y, aux


def moe_apply(cfg, x, p, group: int = MOE_SEQ_CHUNK, dropless: bool = False,
              expert0: int = 0):
    """x [B, S, d] -> (y [B, S, d], aux float32 []) over groups of ``group``
    tokens (one group when S <= group or group does not divide S; the aux
    loss is then the groups' mean).  ``dropless=True`` sizes capacity so no
    assignment is dropped: every inference path passes it.  ``p`` holding
    fewer experts than ``cfg.n_experts`` (expert parallelism) gives the
    partial output of experts ``expert0`` onward (module docstring)."""
    B, S, d = x.shape
    if S <= group or S % group != 0:
        return _moe_group(cfg, x, p, dropless=dropless, expert0=expert0)
    ys, auxs = zip(*(_moe_group(cfg, x[:, i:i + group], p, dropless=dropless,
                                expert0=expert0)
                     for i in range(0, S, group)))
    return torch.cat(ys, dim=1), torch.stack(auxs).mean()
