"""Token-choice top-k Mixture of Experts: capacity-bounded dispatch for
training, a token-major grouped dispatch for serving.

The port of ``repro.models.moe``, forward and backward.  The
same function: a float32 router, top-k gates renormalised to sum to 1,
each assignment's slot within its expert counted per batch row in
(token, choice) order, assignments past an expert's capacity C dropped,
a swiglu FFN per expert over its C slots, and the kept outputs gathered
back and summed under their gates.  The sequence is processed in groups
of ``MOE_SEQ_CHUNK`` tokens when it is longer than one group and a
multiple of it (the reference's ``lax.scan``; here a Python loop).

The router's options (``configs/base.py::PortArchConfig``; the defaults
are the reference's): softmax or sigmoid scores, a per-expert selection
bias (``router_bias`` [E] float32) added to the scores for the choice of
the k experts only, the k gates (the chosen scores) renormalised or not,
then scaled by ``route_scale``.  A shared expert (``ws_gate``/``ws_up``
[d, shared_ff], ``ws_down`` [shared_ff, d]) adds its swiglu of every
token to the routed output, once.

Two layouts, one function:

- Capacity-bounded (``dropless=False``, the training loss; and every
  call on DTensors): capacity (:func:`moe_capacity`) is ``ceil(group·k·cf
  / E)``.  The reference scatters into a ``[B, E, C, d]`` buffer and runs
  three einsums batched over experts; here the buffer is ``[E, B·C, d]``
  with one trash row after it, so each expert's product is one ``bmm``
  slice and a dropped assignment is written to the trash row instead of
  relying on an out-of-range scatter being dropped (on CUDA an
  out-of-range index is a device-side assert).  The gather back clamps
  the dropped slot to C − 1 and multiplies by 0, as the reference's
  clamped gather does.  With ``dropless=True`` on a card in float32 (the
  reduced parity runs) the same layout runs at capacity ``group·k``,
  where no assignment is dropped.
- Token-major (``dropless=True``, which every serving path passes, on the
  CPU or on bf16 CUDA tensors; :func:`_moe_group_token_major`): the
  group's B·S·k assignments are sorted by expert into one static buffer,
  each expert's segment ends at an offset kept on the device, and each of
  the three products is one grouped product of fixed shape over the
  segments (``torch._grouped_mm``: CUTLASS's grouped GEMM on sm_90);
  the outputs go back to assignment order and are summed under the
  gates.  No assignment is dropped and none is padded: the padded layout
  at capacity ``S·k`` gives every expert ``S·k`` rows a batch row, E-fold
  the work.  Assignments a caller marks dead (``live``: the chunk's
  padding positions) and those to experts outside the call's share sort
  past the last segment and are not computed.

The backward is autograd's.  The reference writes the combine's
transpose by hand (``_combine_core``) only to keep GSPMD from
all-gathering the batch; the function is the same as autograd's
transpose of the gather back here: a scatter-add of the kept slots'
cotangents into ``out``, zero for the dropped ones (their gathered row is
multiplied by 0).  The dispatch's transpose likewise gathers each kept
assignment's row of the buffer's cotangent and gives a dropped one 0
(the trash row is outside the expert buffer).

Everything here is a plain tensor op on the caller's device with no host
read: no ``.item()``, no boolean-mask indexing, no ``nonzero``; the
token-major layout's shapes depend on B, S and k alone, so a captured
graph replays it.  Ties in the top-k are broken by the lower expert index,
as ``jax.lax.top_k`` breaks them (a stable descending sort).  The expert
products are library products (``torch.bmm``, ``torch._grouped_mm``), as
the reference leaves its einsums to XLA: this is not one of the repo's
Pallas kernels.

Parameters (per layer): ``w_router`` [d, E] float32 whatever the model's
dtype; ``w_gate``/``w_up`` [E, d, ff] and ``w_down`` [E, ff, d] in the
model's dtype.  Under tensor parallelism (``sharding/rules.py``) each shard
holds the whole router and either an expert-hidden slice of every expert
(``REPRO_MOE_SHARD=tp``) or its own whole experts ``[e0, e0 + E/T)``
(``ep``: ``expert0=e0``, ``w_gate`` [E/T, d, ff]); :func:`moe_apply` over
it gives that shard's partial output, and the partials sum to the whole
layer's output (a shared expert is added by the ``expert0 = 0`` call
alone).  Expert-parallel: every shard routes over all E experts,
dispatches only the assignments to its own experts (the rest go to the
trash row, or past the last segment) and runs the products of its
experts only; capacity and each assignment's slot are counted over all
E, as in the whole layer.
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
    """Slots per expert and batch row for a group of ``group_len`` tokens in
    the capacity-bounded layout (module docstring): the training loss's,
    and with ``dropless`` the worst case, which the token-major serving
    layout does not pad to."""
    if dropless:  # worst case: every assignment routed to one expert
        return group_len * cfg.top_k
    return max(1, int(math.ceil(
        group_len * cfg.top_k * cfg.capacity_factor / cfg.n_experts)))


def init_moe(cfg, gen, dtype=torch.bfloat16, device=None):
    """Seeded expert weights with the reference's shapes and scales; the
    router stays float32.  The port's router options add a selection
    bias (float32, std 0.02) and a shared expert (module docstring)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    std_in, std_out = 0.02, 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    p = {
        "w_router": _normal(gen, (d, E), std_in, torch.float32, device),
        "w_gate": _normal(gen, (E, d, ff), std_in, dtype, device),
        "w_up": _normal(gen, (E, d, ff), std_in, dtype, device),
        "w_down": _normal(gen, (E, ff, d), std_out, dtype, device),
    }
    if cfg.router_bias:
        p["router_bias"] = _normal(gen, (E,), std_in, torch.float32, device)
    if cfg.shared_ff:
        sff = cfg.shared_ff
        p["ws_gate"] = _normal(gen, (d, sff), std_in, dtype, device)
        p["ws_up"] = _normal(gen, (d, sff), std_in, dtype, device)
        p["ws_down"] = _normal(gen, (sff, d), std_out, dtype, device)
    return p


def _route(cfg, x, w_router, bias=None):
    """Router over x [B, S, d] in float32 -> (scores [B, S, E], gate and
    expert [B, S, k]), ties to the lower expert index: softmax or sigmoid
    scores; the k experts chosen by score plus ``bias`` where given; their
    scores as gates, renormalised (with a 1e-20 guard for sigmoid scores,
    which need not sum to anything) and scaled as the config says."""
    logits = x.float() @ w_router.float()
    sigmoid = cfg.router_score == "sigmoid"
    probs = torch.sigmoid(logits) if sigmoid else torch.softmax(logits, -1)
    if bias is None:
        gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, expert = gate[..., :cfg.top_k], expert[..., :cfg.top_k]
    else:
        expert = torch.sort(probs + bias.float(), dim=-1, descending=True,
                            stable=True).indices[..., :cfg.top_k]
        gate = torch.gather(probs, -1, expert)
    total = gate.sum(-1, keepdim=True)
    gate = gate / (total + 1e-20 if sigmoid else total)
    if cfg.route_scale != 1.0:
        gate = gate * cfg.route_scale
    return probs, gate, expert


def _shared(x, p):
    """The shared expert's swiglu of every token."""
    h = F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])
    return h @ p["ws_down"]


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


def token_major(x, dropless: bool) -> bool:
    """Does a call over ``x`` take the token-major layout (module
    docstring): dropless, on the CPU or in bf16 on a card.  On a card the
    grouped product is CUTLASS's for bf16 alone; in float32 it copies its
    offsets to the host, which a captured graph refuses."""
    return dropless and (not x.is_cuda or x.dtype == torch.bfloat16)


def _moe_group(cfg, x, p, dropless: bool = False, expert0: int = 0,
               live=None):
    """One token group.  x [B, S, d] -> (y [B, S, d], aux float32 []); the
    products of experts ``[expert0, expert0 + p["w_gate"].shape[0])``, in
    the token-major layout where :func:`token_major` says so (``live``
    [B, S] bool: the tokens computed, the others give 0), else the
    capacity-bounded one.  Under a mesh: :func:`_moe_group_sharded`."""
    if rules.sharded_on_mesh(x):
        return _moe_group_sharded(cfg, x, p, dropless)
    if token_major(x, dropless):
        return _moe_group_token_major(cfg, x, p, expert0, live)
    B, S, d = x.shape
    k = cfg.top_k
    El = p["w_gate"].shape[0]
    C = moe_capacity(cfg, S, dropless=dropless)
    probs, gate, expert = _route(cfg, x, p["w_router"], p.get("router_bias"))
    flat_e, onehot, pos_in_e, local_e, keep = _slots(cfg, expert, C, El,
                                                     expert0)
    aux = _aux(cfg, probs, onehot.float().sum(dim=1), S)
    eb = _dispatch(x, local_e, pos_in_e, keep, El, C, k)
    out = _experts(eb, p)
    y = _combine(out, local_e, pos_in_e, keep, gate, C)
    if "ws_gate" in p and expert0 == 0:
        y = y + _shared(x, p)
    return y, aux


def _moe_group_token_major(cfg, x, p, expert0: int = 0, live=None):
    """:func:`_moe_group`'s token-major layout (module docstring): x [B, S,
    d] -> (y [B, S, d], aux float32 [])."""
    B, S, d = x.shape
    k = cfg.top_k
    N, A = B * S, B * S * k
    El = p["w_gate"].shape[0]
    probs, gate, expert = _route(cfg, x, p["w_router"], p.get("router_bias"))
    flat_e = expert.reshape(A)
    # the aux loss's per-row assignment counts, as the padded layout has them
    rows = torch.arange(B, device=x.device).repeat_interleave(S * k)
    counts = torch.zeros(B * cfg.n_experts, device=x.device).index_add_(
        0, rows * cfg.n_experts + flat_e,
        torch.ones(A, device=x.device)).view(B, cfg.n_experts)
    aux = _aux(cfg, probs, counts, S)
    local = flat_e - expert0
    keep = (local >= 0) & (local < El)
    if live is not None:
        keep = keep & live.reshape(N, 1).expand(N, k).reshape(A)
    key = torch.where(keep, local, El)  # El: sorted last, not computed
    order = torch.sort(key, stable=True).indices
    per = torch.zeros(El + 1, dtype=torch.int32, device=x.device).index_add_(
        0, key, torch.ones(A, dtype=torch.int32, device=x.device))
    offs = torch.cumsum(per[:El], 0, dtype=torch.int32)
    xs = x.reshape(N, d)[order // k]
    # expert e's segment, rows offs[e-1] .. offs[e] - 1, times its matrix;
    # the rows past offs[-1] are left undefined
    h = (F.silu(torch._grouped_mm(xs, p["w_gate"], offs=offs))
         * torch._grouped_mm(xs, p["w_up"], offs=offs))
    ys = torch._grouped_mm(h, p["w_down"], offs=offs)
    out = torch.empty_like(ys).index_copy_(0, order, ys)
    # an uncomputed row is undefined (it may hold NaN): select, not multiply
    out = torch.where(keep[:, None], out * gate.reshape(A, 1).to(out.dtype),
                      0)
    y = out.view(B, S, k, d).sum(dim=2)
    if "ws_gate" in p and expert0 == 0:
        y = y + _shared(x, p)
        if live is not None:
            y = torch.where(live[..., None], y, 0)
    return y, aux


def _moe_group_sharded(cfg, x, p, dropless: bool):
    """:func:`_moe_group` on DTensors, the reference's layout: the group's
    input sequence-parallel (``shard_seq``); routing, slots and the
    dispatch on each rank's batch rows (the slots count over whole rows);
    the buffer [E, B*C, d] batch over the data axes and experts replicated
    (``shard_experts``); the expert products as DTensor batched products
    over the weights' own placements (each expert's hidden slice: partial
    sums over 'model'; whole experts with ``ep``); the combine on each
    rank's rows and experts, partial where the products were."""
    if "router_bias" in p or "ws_gate" in p:
        raise NotImplementedError("the expert layer on DTensors has no "
                                  "selection bias and no shared expert")
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
              expert0: int = 0, live=None):
    """x [B, S, d] -> (y [B, S, d], aux float32 []) over groups of ``group``
    tokens (one group when S <= group or group does not divide S; the aux
    loss is then the groups' mean).  ``dropless=True`` drops no
    assignment: every inference path passes it, and it takes the
    token-major layout where :func:`token_major` says so.  ``live`` [B, S]
    bool (token-major only): the tokens to compute; the others give 0.
    ``p`` holding fewer experts than ``cfg.n_experts`` (expert
    parallelism) gives the partial output of experts ``expert0`` onward
    (module docstring)."""
    B, S, d = x.shape
    if S <= group or S % group != 0:
        return _moe_group(cfg, x, p, dropless=dropless, expert0=expert0,
                          live=live)
    ys, auxs = zip(*(_moe_group(
        cfg, x[:, i:i + group], p, dropless=dropless, expert0=expert0,
        live=None if live is None else live[:, i:i + group])
        for i in range(0, S, group)))
    return torch.cat(ys, dim=1), torch.stack(auxs).mean()
