"""Grouped-query attention with RoPE, sliding windows, logit soft-capping,
QK-norm and prefix-LM masking.  ``AttnConfig.rope=False`` leaves the
positions out (NoPE), and ``q_scale`` replaces the query scale
``d_head ** -0.5``; the queries reach the attention plan already scaled
either way.

Prefill uses the statically-chunked causal schedule of the JAX package: a
loop over query chunks where chunk ``i`` attends the key prefix
``[start_i, (i+1)*chunk)``.  Torch runs the chunks in order, so no
barrier between them is needed.

The whole ``softmax(mask(Q K^T)) V`` subgraph routes through
``core.dispatch_attention``: the scoped policy picks the fused kernel or
the unfused plan.  The leading ``(batch, kv)`` axes collapse to the
OpKey's batch extent ``g`` and the GQA group folds into the per-slice
query extent (declared with ``q_seg``), so K/V are never materialised at
``n_heads`` width.

Tensor parallelism (``layers.dense_tp``).  When the ``model`` axis splits
wq, wk and wv along their outputs and divides both head counts, each
rank attends its own heads, and wo sums the ranks' partial outputs.
Where a split misses a head boundary -- smollm-135m's 9 heads and 3 kv
heads over 2 ranks, whose 576- and 192-wide outputs the rules still
split -- the projections' outputs are gathered before the head reshape,
every rank attends every head, and wo takes this rank's columns of the
result.  Decode caches follow ``distributed.sharding.cache_specs_tree``:
kv heads over ``model`` when they divide it, else the slots (and the
slots over the data axes when the batch does not divide them); a
slot-split cache is written by the rank that owns the new position's
slot and gathered whole for attention.

Sequence-parallel attention (``AttnConfig.sp_attention``, the JAX
package's ``constrain`` over the query rows).  Where the heads do not
split over ``model``, each rank takes its ``C/M`` rows of every query
chunk of ``C`` -- rank ``r`` the rows ``[r C/M, (r+1) C/M)`` of each --
and attends them, for every head, against the chunk's whole key slab;
the attention output is gathered back whole, in position order, before
wo and the residual.  A projection whose weight the rules leave whole
(smollm-135m's at ``MIN_MODEL_DIM`` 1024) runs on this rank's rows, its
weight entering through ``copy_to_group`` (its gradient is the group's
sum of the ranks' rows); the keys and values of those rows are gathered
whole with ``gather_seq``, whose backward reduce-scatters.  A
projection the rules split (gemma3-4b's 2048-wide ``wq`` at 16) runs as
above through the head-boundary gather, and the queries are then cut to
this rank's rows (``scatter_to_group``: the rows' gradients gathered
back), the keys and values kept whole through ``copy_to_group`` (the
ranks' gradients summed).  Where ``C`` does not divide by ``M``, or the
heads do split over ``model``, the layer runs as without it; the prefill
cache is built from the whole keys and values, and decode is unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.engine import dispatch_attention
from repro_torch.distributed.collectives import (
    all_gather,
    copy_to_group,
    gather_from_group,
    gather_seq,
    scatter_to_group,
)
from repro_torch.distributed.context import current_mesh, model_size
from repro_torch.distributed.sharding import _spec_for_cache, spec_axes
from repro_torch.launch.mesh import Mesh

from .layers import Param, dense, dense_tp, init_dense, init_rmsnorm, rmsnorm, tp_mesh, weight_dim
from .rope import apply_rope

__all__ = [
    "AttnConfig",
    "init_attention",
    "attention",
    "attention_decode",
    "init_attn_cache",
]


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    window: Optional[int] = None  # None => global attention
    softcap: float = 0.0
    rope_theta: float = 10000.0
    qk_norm: bool = False
    chunk: int = 1024  # query-chunk length for the blocked schedule
    # shard the attention block over ``model`` along the query rows where
    # the heads do not divide it (the module docstring)
    sp_attention: bool = False
    rope: bool = True  # False: NoPE
    q_scale: Optional[float] = None  # None: d_head ** -0.5

    @property
    def group(self) -> int:
        assert self.n_heads % self.n_kv == 0
        return self.n_heads // self.n_kv

    @property
    def scale(self) -> float:
        return self.q_scale if self.q_scale is not None else self.d_head**-0.5


def init_attention(gen: torch.Generator, cfg: AttnConfig, dtype=torch.float32,
                   device="cpu") -> Param:
    p = {
        "wq": init_dense(gen, cfg.n_heads * cfg.d_head, cfg.d_model, dtype, device),
        "wk": init_dense(gen, cfg.n_kv * cfg.d_head, cfg.d_model, dtype, device),
        "wv": init_dense(gen, cfg.n_kv * cfg.d_head, cfg.d_model, dtype, device),
        "wo": init_dense(gen, cfg.d_model, cfg.n_heads * cfg.d_head, dtype, device),
    }
    if cfg.qk_norm:
        p["qn"] = init_rmsnorm(cfg.d_head, dtype, device)
        p["kn"] = init_rmsnorm(cfg.d_head, dtype, device)
    return p


@dataclass(frozen=True)
class _Split:
    """How the ``model`` axis splits one attention layer: the split dim of
    wq, wk, wv and wo (``layers.weight_dim``) and whether each rank
    attends its own heads (``local``)."""

    dims: Tuple[Optional[int], ...]
    local: bool
    m: int


def _split(cfg: AttnConfig) -> Optional[_Split]:
    mesh = tp_mesh()
    if mesh is None:
        return None
    m = model_size(mesh)
    d, qw, kw = cfg.d_model, cfg.n_heads * cfg.d_head, cfg.n_kv * cfg.d_head
    dims = tuple(weight_dim((n, "w"), shape) for n, shape in
                 (("wq", (qw, d)), ("wk", (kw, d)), ("wv", (kw, d)), ("wo", (d, qw))))
    local = dims[:3] == (0, 0, 0) and cfg.n_heads % m == 0 and cfg.n_kv % m == 0
    return _Split(dims, local, m)


def _slots_split(cfg: AttnConfig, sp: _Split, batch: int, slots: int) -> bool:
    """Whether the cache's slot dim of ``slots`` (full extent) is split
    over ``model``: the cache rules on the mesh's model axis."""
    spec = _spec_for_cache(("k",), (1, batch, slots, cfg.n_kv, cfg.d_head),
                           Mesh((1, sp.m), ("data", "model")))
    assert (spec[-2] == "model") == sp.local, (spec, sp)
    return spec[-3] == "model"


def _project_qkv(
    p: Param, x: torch.Tensor, cfg: AttnConfig, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, AttnConfig]:
    """x:(B,S,d) -> q:(B,S,kv,g,dh), k/v:(B,S,kv,dh), RoPE'd and normed,
    and the config of the heads this rank attends (its own under a
    head-local split, else all of them)."""
    B, S, _ = x.shape
    sp = _split(cfg)
    if sp is None:
        q, k, v = (dense(p[n], x) for n in ("wq", "wk", "wv"))
    else:
        xc = copy_to_group(x) if 0 in sp.dims[:3] else x
        outs = []
        for name, wd in zip(("wq", "wk", "wv"), sp.dims):
            y, y_split = dense_tp(p[name], xc if wd == 0 else x, wd, copied=True)
            outs.append(gather_from_group(y) if y_split and not sp.local else y)
        q, k, v = outs
        if sp.local:
            cfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // sp.m, n_kv=cfg.n_kv // sp.m)
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv, cfg.d_head)
    if cfg.qk_norm:
        qn, kn = p["qn"], p["kn"]
        if sp is not None and sp.local:  # whole scales over this rank's heads only:
            # their gradients are the group's sum
            qn, kn = ({"scale": copy_to_group(n["scale"])} for n in (qn, kn))
        q = rmsnorm(qn, q)
        k = rmsnorm(kn, k)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = q.reshape(B, S, cfg.n_kv, cfg.group, cfg.d_head)
    return q, k, v, cfg


def _rows(t: torch.Tensor, chunk: int, m: int) -> torch.Tensor:
    """(B, S, ...) -> (B, S/m, ...): this rank's ``chunk/m`` rows of each
    chunk, in order; their gradient is gathered back whole."""
    B, S = t.shape[:2]
    t = t.reshape(B, S // chunk, chunk, *t.shape[2:])
    return scatter_to_group(t, "model", dim=2).reshape(B, S // m, *t.shape[3:])


def _unrows(t: torch.Tensor, chunk: int, m: int, gather) -> torch.Tensor:
    """``_rows``'s inverse: every rank's rows gathered back into position
    order over ``model`` with ``gather`` (``gather_seq`` or
    ``gather_from_group``): (B, S/m, ...) -> (B, S, ...)."""
    B, n = t.shape[:2]
    t = t.reshape(B, n * m // chunk, chunk // m, *t.shape[2:])
    return gather(t, "model", 2).reshape(B, n * m, *t.shape[3:])


def _sp_project(p: Param, x: torch.Tensor, cfg: AttnConfig, positions: torch.Tensor,
                sp: _Split, chunk: int):
    """Sequence-parallel projections (the module docstring): this rank's
    query rows ``(B, S/M, kv, g, dh)`` and the whole keys and values
    ``(B, S, kv, dh)``, RoPE'd and normed, every head."""
    B, S, _ = x.shape
    m = sp.m
    r = current_mesh().axis_index("model")
    pos = positions.reshape(positions.shape[0], S // chunk, chunk)
    pos_rows = pos[..., r * (chunk // m):(r + 1) * (chunk // m)].reshape(-1, S // m)
    x_rows = _rows(x, chunk, m) if None in sp.dims[:3] else None
    xc = copy_to_group(x) if 0 in sp.dims[:3] else x
    out = []
    for name, wd, heads in zip(("wq", "wk", "wv"), sp.dims, (cfg.n_heads, cfg.n_kv, cfg.n_kv)):
        if wd is None:  # this rank's rows; a whole weight's gradient is the group's sum
            y = dense({k: copy_to_group(w) for k, w in p[name].items()}, x_rows)
            rows = True
        else:
            y, y_split = dense_tp(p[name], xc if wd == 0 else x, wd, copied=True)
            y = gather_from_group(y) if y_split else y
            rows = False
        y = y.reshape(B, y.shape[1], heads, cfg.d_head)
        norm = {"wq": "qn", "wk": "kn"}.get(name) if cfg.qk_norm else None
        if norm is not None:
            scale = p[norm]["scale"]
            y = rmsnorm({"scale": copy_to_group(scale) if rows else scale}, y)
        if name != "wv" and cfg.rope:
            y = apply_rope(y, pos_rows if rows else positions, cfg.rope_theta)
        if name == "wq":
            y = y if rows else _rows(y, chunk, m)
        elif rows:
            y = _unrows(y, chunk, m, gather_seq)
        else:  # whole on every rank; each rank's queries give it a share of the gradient
            y = copy_to_group(y)
        out.append(y)
    q, k, v = out
    return q.reshape(B, S // m, cfg.n_kv, cfg.group, cfg.d_head), k, v


def _out_proj(p: Param, out: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    """wo over the attention output: this rank's heads' columns under a
    head-local split, else this rank's slice of all of them."""
    sp = _split(cfg)
    if sp is None:
        return dense(p["wo"], out)
    y, y_split = dense_tp(p["wo"], out, sp.dims[3], x_split=sp.local)
    return gather_from_group(y) if y_split else y


def _chunk_attend(
    q_chunk: torch.Tensor,  # (B, C, kv, g, dh) already scaled
    k_slab: torch.Tensor,  # (B, L, kv, dh)
    v_slab: torch.Tensor,  # (B, L, kv, dh)
    cfg: AttnConfig,
    q_lo: int,  # absolute position of this chunk's first query
    k_lo: int,  # absolute position of the slab's first key
    prefix_len: int,
) -> torch.Tensor:
    """One query chunk's attention as a policy-dispatched plan.  The GQA
    group folds into the per-slice query extent (m = g*C); ``q_seg=C``
    puts row ``r`` of a slice at position ``q_lo + r % C``."""
    B, C, kv, g, dh = q_chunk.shape
    L = k_slab.shape[1]
    q2 = q_chunk.permute(0, 2, 3, 1, 4).reshape(B * kv, g * C, dh)
    k2 = k_slab.transpose(1, 2).reshape(B * kv, L, dh)
    v2 = v_slab.transpose(1, 2).reshape(B * kv, L, dh)
    out = dispatch_attention(
        q2, k2, v2,
        causal=True,
        window=cfg.window or 0,
        q_start=q_lo,
        k_start=k_lo,
        prefix_len=prefix_len,
        q_seg=C,
        softcap=cfg.softcap,
    )
    out = out.reshape(B, kv, g, C, dh)
    return out.permute(0, 3, 1, 2, 4)  # (B, C, kv, g, dh)


def attention(
    p: Param,
    x: torch.Tensor,
    cfg: AttnConfig,
    positions: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
    return_kv: bool = False,
    max_seq: Optional[int] = None,
    cache_dtype=torch.bfloat16,
    true_len=None,
):
    """Prefill attention.  x: (B, S, d_model) -> (B, S, d_model).

    With ``return_kv`` also returns a decode cache covering this prefill
    (ring-ordered for windowed layers; padded to ``max_seq`` for global).
    ``true_len`` (int or ``(B,)`` tensor) marks a right-padded prefill:
    only the first ``true_len`` positions of each row are real tokens, and
    the windowed ring holds the last ``window`` real positions."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    full_cfg = cfg
    chunk = min(cfg.chunk, S)
    if S % chunk != 0:  # ragged tail: single chunk
        chunk = S
    sp = _split(cfg)
    if cfg.sp_attention and sp is not None and not sp.local and chunk % sp.m == 0:
        q, k, v = _sp_project(p, x, cfg, positions, sp, chunk)
        rows = chunk // sp.m  # this rank's rows of each chunk, from its first
        first = current_mesh().axis_index("model") * rows
    else:
        q, k, v, cfg = _project_qkv(p, x, cfg, positions)
        rows, first = chunk, 0
    q = q * cfg.scale

    outs = []
    for i in range(S // chunk):
        q_lo, q_hi = i * chunk, (i + 1) * chunk
        if cfg.window is not None:
            # earliest key any query in this chunk may see, block-aligned
            lo = max(0, ((q_lo - cfg.window + 1) // chunk) * chunk)
        else:
            lo = 0
        if prefix_len > 0:
            lo = 0  # prefix keys always visible
        outs.append(_chunk_attend(
            q[:, i * rows:(i + 1) * rows], k[:, lo:q_hi], v[:, lo:q_hi], cfg, q_lo + first,
            lo, prefix_len
        ))
    out = torch.cat(outs, dim=1).reshape(B, q.shape[1], cfg.n_heads * cfg.d_head)
    if rows != chunk:  # every rank's rows back in position order
        out = _unrows(out, chunk, sp.m, gather_from_group)
    out = _out_proj(p, out, full_cfg)
    if not return_kv:
        return out
    max_seq = max_seq or S
    slots = min(cfg.window, max_seq) if cfg.window is not None else max_seq
    if cfg.window is not None and (true_len is not None or S >= slots):
        # Ring order: slot i holds the newest position p < true_len with
        # p = i (mod slots); slots with no such position gather junk that
        # the decode validity mask excludes.
        tl = torch.as_tensor(S if true_len is None else true_len, device=x.device)
        tl_b = tl.reshape(-1).expand(B)[:, None].long()  # (B, 1)
        i = torch.arange(slots, device=x.device)[None, :]
        src = (tl_b - 1 - ((tl_b - 1 - i) % slots)).clamp(0, S - 1)  # (B, slots)
        rows = torch.arange(B, device=x.device)[:, None]
        ck, cv = k[rows, src], v[rows, src]
    else:
        pad = (0, 0, 0, 0, 0, slots - S)
        ck, cv = F.pad(k, pad), F.pad(v, pad)
    if sp is not None and _slots_split(full_cfg, sp, B, slots):
        part = slots // sp.m
        lo = current_mesh().axis_index("model") * part
        ck, cv = (c.narrow(1, lo, part).contiguous() for c in (ck, cv))
    return out, {"k": ck.to(cache_dtype), "v": cv.to(cache_dtype)}


# -- decode (one new token against a cache) ----------------------------------


def init_attn_cache(batch: int, cfg: AttnConfig, max_seq: int, dtype=torch.bfloat16,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Ring buffer of ``window`` slots for local layers, else ``max_seq``."""
    slots = min(cfg.window, max_seq) if cfg.window is not None else max_seq
    shape = (batch, slots, cfg.n_kv, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def attention_decode(
    p: Param,
    x: torch.Tensor,  # (B, 1, d_model)
    cfg: AttnConfig,
    cache: Dict[str, torch.Tensor],
    pos,  # int / scalar tensor, or (B,) per-sequence positions
    cspec=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  ``pos`` is the index of each row's new token.

    Each row writes its K/V at its own position -- in place, with
    ``index_copy_`` into the cache tensors (the JAX package returns a new
    cache from donated buffers) -- and attends only the slots its own
    length has filled (per-row ``lengths`` of the attention plan).
    Where the mesh splits the cache's slots -- over ``model`` when the kv
    heads do not divide it, over the data axes when the batch does not --
    the rank owning the new position's slot writes it and the cache is
    gathered whole for attention.  ``cspec``, the spec of this layer's
    ``k`` leaf (``cache_specs_tree``), names the slots' axes (None: the
    slots are whole)."""
    B = x.shape[0]
    full_cfg = cfg
    slots = cache["k"].shape[1]
    pos_b = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B).long()
    q, k_new, v_new, cfg = _project_qkv(p, x, cfg, pos_b[:, None])
    q = q * cfg.scale

    axes = spec_axes(cspec[-3]) if cspec is not None else ()
    total, lo = slots, 0
    if axes:
        mesh = current_mesh()
        total, lo = slots * mesh.axis_size(axes), mesh.axis_index(axes) * slots
    write = (pos_b % total if cfg.window is not None else pos_b) - lo
    mine = (write >= 0) & (write < slots)
    flat = torch.arange(B, device=x.device) * slots + write.clamp(0, slots - 1)
    for name, new in (("k", k_new), ("v", v_new)):
        rows = cache[name].view(B * slots, cfg.n_kv, cfg.d_head)
        new = new[:, 0].to(rows.dtype)
        if total != slots:  # another rank owns some rows' slots: leave theirs
            new = torch.where(mine[:, None, None], new, rows[flat])
        rows.index_copy_(0, flat, new)
    kc, vc = cache["k"], cache["v"]
    if total != slots:
        kc, vc = (all_gather(c, axes, dim=1) for c in (kc, vc))

    lengths = torch.repeat_interleave(torch.clamp(pos_b + 1, max=total), cfg.n_kv)
    q2 = q.permute(0, 2, 3, 1, 4).reshape(B * cfg.n_kv, cfg.group, cfg.d_head)
    k2 = kc.to(q.dtype).transpose(1, 2).reshape(B * cfg.n_kv, total, cfg.d_head)
    v2 = vc.to(q.dtype).transpose(1, 2).reshape(B * cfg.n_kv, total, cfg.d_head)
    out = dispatch_attention(q2, k2, v2, lengths=lengths, softcap=cfg.softcap)
    out = out.reshape(B, 1, cfg.n_heads * cfg.d_head)
    return _out_proj(p, out, full_cfg), cache
