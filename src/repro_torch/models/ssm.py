"""Mamba-2 SSD (state-space duality) layer: the chunked training form,
quadratic within a chunk and linear across chunks, and the O(1)-state
decode form.

The JAX package's layer (Dao & Gu 2024, section 6) with ``ngroups=1``
(B and C shared across heads).  The short causal conv runs over x alone
by default, as the JAX package's does; with ``SSMConfig.conv_xbc`` it
runs over x, B and C together, as the published Mamba-2 layer and
granite-4.0-h-small's do: its taps, bias and decode cache are then
``d_inner + 2 d_state`` wide (``SSMConfig.conv_width``), and B and C
come out of the conv.  Every projection is ``dense``, the paper's NT
op through ``core.engine.dispatch``; the SSD's contractions are
``torch.einsum`` products, as the JAX package leaves them to
``jnp.einsum``.  The inter-chunk scan is a Python loop over chunks (the
JAX package scans them).  A length that is not a multiple of the chunk
keeps the chunk length: the tail is padded to a whole chunk with dt = 0
and x = B = C = 0, which adds nothing to the state and leaves its decay
as it was, and the padded rows' outputs are dropped.  The casts follow
the JAX package's: B and C run in the activation dtype, the scores and
the carried state too, and decode works in f32 and stores the state in
the cache dtype.  The gated norm takes the model's epsilon (``eps``).

Spans (``core/spans.py``): ``repro_torch.ssm.scan`` around the SSD of a
prefill or forward and around the state update of a decode step.

Under a mesh whose ``model`` axis is larger than one, each rank holds
the pieces the sharding rules give: ``wz``, ``wx``, ``conv_w`` and
``wdt`` split by head, ``wB`` and ``wC`` over d_state where ``model``
divides it (else over their input dim), ``out`` over its input dim.
Where the heads divide ``model`` each rank runs the SSD on its own
heads: the replicated per-head vectors (``A_log``, ``D``, ``dt_bias``,
``conv_b``) are sliced to them, B and C are gathered whole (every head
contracts all N states) and enter through ``copy_to_group``, the gated
norm's mean square is the group's (``rmsnorm(split=True)``), and ``out``
sums the ranks' partial outputs.  The decode caches follow
``cache_specs_tree``: ``ssm`` over heads, ``conv`` over d_inner.  Where a
split misses a head boundary, every projection's output is gathered
whole, every rank runs every head, and ``out`` takes this rank's columns
(the head-boundary gather of ``attention.py``); a ``conv`` cache split
over d_inner is then cut from the whole state and gathered back to
decode.  The xBC conv is not served on a mesh: it raises there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import spans
from repro_torch.distributed.collectives import (
    all_gather,
    copy_to_group,
    gather_from_group,
)
from repro_torch.distributed.context import current_mesh
from repro_torch.distributed.sharding import _spec_for_cache
from repro_torch.launch.mesh import Mesh

from .layers import (
    Param,
    _normal,
    dense,
    dense_tp,
    group_slice,
    init_dense,
    init_rmsnorm,
    rmsnorm,
    tp_mesh,
    weight_dim,
)

__all__ = ["SSMConfig", "init_ssm", "ssm_layer", "ssm_decode", "init_ssm_cache"]


@dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64
    # the conv over x, B and C together (the module docstring)
    conv_xbc: bool = False

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def conv_width(self) -> int:
        """The channels the conv runs over."""
        return self.d_inner + 2 * self.d_state if self.conv_xbc else self.d_inner

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim


def init_ssm(gen: torch.Generator, cfg: SSMConfig, dtype=torch.float32, device="cpu") -> Param:
    """The JAX package's tree; ``A_log``, ``D`` and ``dt_bias`` are f32
    whatever ``dtype`` is."""
    H = cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wz": init_dense(gen, cfg.d_inner, cfg.d_model, dtype, device),
        "wx": init_dense(gen, cfg.d_inner, cfg.d_model, dtype, device),
        "wB": init_dense(gen, cfg.d_state, cfg.d_model, dtype, device),
        "wC": init_dense(gen, cfg.d_state, cfg.d_model, dtype, device),
        "wdt": init_dense(gen, H, cfg.d_model, dtype, device),
        "conv_w": _normal(gen, (cfg.d_conv, cfg.conv_width), 0.1, dtype, device),
        "conv_b": torch.zeros((cfg.conv_width,), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), **f32),  # A = -exp(A_log) = -1
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": init_rmsnorm(cfg.d_inner, dtype, device),
        "out": init_dense(gen, cfg.d_model, cfg.d_inner, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, d_inner) with taps (d_conv, d_inner)."""
    d_conv, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    out = torch.zeros_like(x)
    for t in range(d_conv):
        out = out + pad[:, t: t + S] * w[t]
    return F.silu(out + b)


def _ssd_chunked(
    xh: torch.Tensor,  # (B, S, H, P)
    Bv: torch.Tensor,  # (B, S, N)
    Cv: torch.Tensor,  # (B, S, N)
    dt: torch.Tensor,  # (B, S, H) post-softplus, f32
    A: torch.Tensor,  # (H,) negative, f32
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B, S, H, P), h_final: (B, H, P, N)).  A ragged tail
    is padded to a whole chunk with dt = x = B = C = 0 (the module
    docstring)."""
    Bsz, S, H, P = xh.shape
    N = Bv.shape[-1]
    L = min(chunk, S)
    pad = -S % L
    if pad:
        xh, Bv, Cv, dt = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xh, Bv, Cv, dt))
    nc = (S + pad) // L
    xh, Bv, Cv, dt = (t.reshape((Bsz, nc, L) + t.shape[2:]) for t in (xh, Bv, Cv, dt))

    a = dt * A  # (B, nc, L, H) log-decay per step
    cum = torch.cumsum(a, dim=2)  # inclusive within-chunk cumsum

    # intra-chunk (quadratic in L): scores[b,c,l,s,h] = (C_l.B_s) L[l,s,h].
    # Above the diagonal exp(cum_l - cum_s) overflows to inf for a long
    # chunk; ``where`` drops it (a 0/1 mask would give inf * 0 = NaN).
    cb = torch.einsum("bcln,bcsn->bcls", Cv, Bv)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (B,nc,L,L,H)
    causal = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()
    scores = cb[..., None] * decay * dt[:, :, None, :, :]
    scores = torch.where(causal[None, None, :, :, None], scores, 0.0)
    del decay
    y = torch.einsum("bclsh,bcshp->bclhp", scores.to(xh.dtype), xh)
    del scores

    # chunk summaries: S_c[b,h,p,n] = sum_s exp(cum_L - cum_s) dt_s x_s B_s
    seg = torch.exp(cum[:, :, -1:, :] - cum) * dt  # (B, nc, L, H)
    states = torch.einsum("bclh,bclhp,bcln->bchpn", seg.to(xh.dtype), xh, Bv)

    # inter-chunk scan: H_c = exp(cum_L_c) H_{c-1} + S_c, carried in xh's dtype
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    h = torch.zeros((Bsz, H, P, N), dtype=xh.dtype, device=xh.device) if h0 is None else h0
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)  # the state *before* chunk c
        h = h * chunk_decay[:, c, :, None, None].to(h.dtype) + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (B, nc, H, P, N)

    # inter-chunk contribution: y_t += C_t . (exp(cum_t) H_prev)
    inter = torch.einsum("bcln,bchpn,bclh->bclhp", Cv, h_prevs, torch.exp(cum).to(xh.dtype))
    y = (y + inter).reshape(Bsz, nc * L, H, P)
    return y[:, :S], h


@dataclass(frozen=True)
class _Split:
    """How the ``model`` axis splits one Mamba layer: each projection's
    split dim (``layers.weight_dim``), whether each rank runs its own
    heads (``local``), the group's size and whether the ``conv`` cache is
    split over d_inner."""

    dims: Dict[str, Optional[int]]
    local: bool
    m: int
    conv_split: bool


def _split(cfg: SSMConfig) -> Optional[_Split]:
    mesh = tp_mesh()
    if mesh is None:
        return None
    m = mesh.shape["model"]
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    dims = {n: weight_dim((n, "w"), shape) for n, shape in (
        ("wz", (di, d)), ("wx", (di, d)), ("wB", (N, d)), ("wC", (N, d)), ("wdt", (H, d)),
        ("out", (d, di)))}
    dims["conv_w"] = weight_dim(("conv_w",), (cfg.d_conv, di))
    local = (dims["wz"], dims["wx"], dims["wdt"], dims["conv_w"]) == (0, 0, 0, 1) and H % m == 0
    spec = _spec_for_cache(("conv",), (1, 1, cfg.d_conv - 1, di), Mesh((1, m), ("data", "model")))
    return _Split(dims, local, m, spec[-1] == "model")


def _whole(p: Param, x: torch.Tensor, xc: torch.Tensor, wdim: Optional[int]) -> torch.Tensor:
    """A projection's output whole on every rank; ``xc`` is ``x`` through
    ``copy_to_group`` (the out-split projections' shared copy)."""
    y, y_split = dense_tp(p, xc if wdim == 0 else x, wdim, copied=True)
    return gather_from_group(y) if y_split else y


def _project(p: Param, x: torch.Tensor, cfg: SSMConfig, sp: Optional[_Split]):
    """(z, xi_raw, B, C, dt_raw, q): the input projections of this rank's
    channels (all of them off a head-local split) and ``q``, the conv taps
    and bias, ``A_log``, ``D`` and ``dt_bias`` of those channels' heads."""
    names = ("conv_w", "conv_b", "A_log", "D", "dt_bias")
    if sp is None:
        outs = [dense(p[n], x) for n in ("wz", "wx", "wB", "wC", "wdt")]
        return (*outs, {n: p[n] for n in names})
    xc = copy_to_group(x) if 0 in sp.dims.values() else x
    if not sp.local:  # every rank runs every head
        outs = [_whole(p[n], x, xc, sp.dims[n]) for n in ("wz", "wx", "wB", "wC", "wdt")]
        q = {n: p[n] for n in names}
        if sp.dims["conv_w"] is not None:
            q["conv_w"] = gather_from_group(p["conv_w"])
        return (*outs, q)
    z, xi_raw, dt_raw = (dense_tp(p[n], xc, 0, copied=True)[0] for n in ("wz", "wx", "wdt"))
    # every head contracts all N states: B and C whole, their gradient the group's sum
    Bv, Cv = (copy_to_group(_whole(p[n], x, xc, sp.dims[n])) for n in ("wB", "wC"))
    di, H = cfg.d_inner // sp.m, cfg.n_heads // sp.m
    q = {"conv_w": p["conv_w"], "conv_b": group_slice(p["conv_b"], di)}
    q.update({n: group_slice(p[n], H) for n in ("A_log", "D", "dt_bias")})
    return z, xi_raw, Bv, Cv, dt_raw, q


def _gate_out(p: Param, y: torch.Tensor, z: torch.Tensor, sp: Optional[_Split],
              eps: float) -> torch.Tensor:
    """The gated RMSNorm over the whole d_inner, then ``out``."""
    split = sp is not None and sp.local
    y = rmsnorm(p["norm"], y * F.silu(z), eps=eps, split=split)
    out, _ = dense_tp(p["out"], y, sp.dims["out"] if sp else None, x_split=split)
    return out


def _conv_piece(conv: torch.Tensor, sp: Optional[_Split]) -> torch.Tensor:
    """This rank's piece of a whole ``conv`` state (off a head-local split
    whose cache splits d_inner)."""
    if sp is None or sp.local or not sp.conv_split:
        return conv
    n = conv.shape[-1] // sp.m
    return conv.narrow(-1, current_mesh().axis_index("model") * n, n)


def _mesh_check(cfg: SSMConfig, sp: Optional[_Split]) -> None:
    if cfg.conv_xbc and sp is not None:
        raise NotImplementedError("the xBC conv (SSMConfig.conv_xbc) is not served on a mesh "
                                  "whose model axis splits the Mamba layer")


def _split_xbc(xbc: torch.Tensor, cfg: SSMConfig):
    """(x, B, C) of the conv's output over x, B and C together."""
    di, N = cfg.d_inner, cfg.d_state
    return xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]


def ssm_layer(p: Param, x: torch.Tensor, cfg: SSMConfig, return_state: bool = False,
              cache_dtype=torch.bfloat16, eps: float = 1e-6):
    """x: (B, S, d_model) -> (B, S, d_model) [, decode cache]."""
    B, S, _ = x.shape
    sp = _split(cfg)
    _mesh_check(cfg, sp)
    z, xi_raw, Bv, Cv, dt_raw, q = _project(p, x, cfg, sp)
    if cfg.conv_xbc:
        xi_raw = torch.cat([xi_raw, Bv, Cv], dim=-1)
        xi, Bv, Cv = _split_xbc(_causal_conv(xi_raw, q["conv_w"], q["conv_b"]), cfg)
    else:
        xi = _causal_conv(xi_raw, q["conv_w"], q["conv_b"])
    Bv, Cv = Bv.float(), Cv.float()
    dt = F.softplus(dt_raw.float() + q["dt_bias"])
    A = -torch.exp(q["A_log"])
    xh = xi.reshape(B, S, -1, cfg.head_dim)
    with spans.span("repro_torch.ssm.scan", tokens=B * S):
        y, h_final = _ssd_chunked(xh, Bv.to(xh.dtype), Cv.to(xh.dtype), dt, A, cfg.chunk)
    y = y + xh * q["D"][None, None, :, None].to(xh.dtype)
    out = _gate_out(p, y.reshape(B, S, -1), z, sp, eps)
    if not return_state:
        return out
    tail = cfg.d_conv - 1
    conv_cache = xi_raw[:, S - tail:] if S >= tail else F.pad(xi_raw, (0, 0, tail - S, 0))
    conv_cache = _conv_piece(conv_cache, sp)
    return out, {"conv": conv_cache.to(cache_dtype), "ssm": h_final.to(cache_dtype)}


# -- decode -------------------------------------------------------------------


def init_ssm_cache(batch: int, cfg: SSMConfig, dtype=torch.bfloat16,
                   device="cpu") -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_width), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state), dtype=dtype,
                           device=device),
    }


def ssm_decode(
    p: Param,
    x: torch.Tensor,  # (B, 1, d_model)
    cfg: SSMConfig,
    cache: Dict[str, Any],
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step; returns the output and a new cache (the input
    cache is left as it was)."""
    B = x.shape[0]
    sp = _split(cfg)
    _mesh_check(cfg, sp)
    z, xi_raw, Bv, Cv, dt_raw, q = _project(p, x, cfg, sp)
    if cfg.conv_xbc:
        xi_raw = torch.cat([xi_raw, Bv, Cv], dim=-1)
    z, xi_raw = z[:, 0], xi_raw[:, 0]  # (B, conv_width)

    # conv ring: taps over [cache, new]
    conv = cache["conv"]
    if sp is not None and not sp.local and sp.conv_split:  # whole heads, a split cache
        conv = all_gather(conv, "model", dim=-1)
    hist = torch.cat([conv.to(xi_raw.dtype), xi_raw[:, None]], dim=1)
    conv_out = torch.einsum("btd,td->bd", hist, q["conv_w"]) + q["conv_b"]
    xi = F.silu(conv_out)
    new_conv = _conv_piece(hist[:, 1:], sp).to(cache["conv"].dtype)
    if cfg.conv_xbc:
        xi, Bv, Cv = _split_xbc(xi, cfg)
        Bv, Cv = Bv.float(), Cv.float()  # (B, N)
    else:
        Bv, Cv = Bv[:, 0].float(), Cv[:, 0].float()  # (B, N)

    dt = F.softplus(dt_raw[:, 0].float() + q["dt_bias"])  # (B, H)
    A = -torch.exp(q["A_log"])
    xh = xi.reshape(B, -1, cfg.head_dim)

    with spans.span("repro_torch.ssm.scan", tokens=B):
        dA = torch.exp(dt * A)  # (B, H)
        h = cache["ssm"].float()
        h = h * dA[..., None, None] + torch.einsum("bh,bhp,bn->bhpn", dt, xh.float(), Bv)
        y = torch.einsum("bn,bhpn->bhp", Cv, h) + xh.float() * q["D"][None, :, None]
    y = y.reshape(B, 1, -1).to(x.dtype)
    out = _gate_out(p, y, z[:, None], sp, eps)
    return out, {"conv": new_conv, "ssm": h.to(cache["ssm"].dtype)}
