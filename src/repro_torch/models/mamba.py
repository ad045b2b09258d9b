"""Mamba-1 (falcon-mamba) selective scan and Mamba-2 (zamba2) SSD, plus
O(1) decode state steps — the port's counterpart of
``repro.models.mamba``.

The reference computes both mixers in XLA ops, with no Pallas kernel, so
torch ops are their port:

* mamba1: the reference's ``lax.scan`` over chunks of ``chunk`` tokens
  becomes a loop over chunks carrying the float32 state; inside a chunk,
  ``cfg.ssm_scan == "assoc"`` runs :func:`associative_scan`, the
  reference's ``jax.lax.associative_scan`` written with torch slicing (the
  same odd/even recursion, so the same pairs are combined in the same
  order, log-depth in the chunk length), and ``"cumsum"`` its log-space
  prefix form with the same ±60 clamps. The discretized
  ``[B, Q, d_inner, d_state]`` tensors exist one chunk at a time.
* mamba2: the SSD block decomposition, einsum for einsum: intra-chunk
  ``[Q, Q]``-per-head products, chunk states, the inter-chunk recurrence by
  :func:`associative_scan` over the chunks, and each chunk's incoming
  state.

``jax.nn.softplus`` is ``logaddexp(x, 0)``, which :func:`_softplus` keeps
(``F.softplus`` turns into the identity above 20). States are float32; the
conv window is in the activations' dtype. One op differs from the
reference's on purpose: a decode step sums the conv's taps as the forward
does (:func:`_conv_step`), so in bf16 a decode continues the forward bit
for bit where the reference's drifts by an ulp of the conv a layer.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..parallel import dtensor as DT
from ..parallel.dtensor import batch_placements, local_call
from .config import ModelConfig
from .layers import Params, dense_init, rms_norm

__all__ = ["MambaState", "associative_scan", "mamba1_params",
           "mamba1_forward", "mamba1_inputs", "mamba1_scan", "mamba1_output",
           "mamba1_decode", "mamba2_params",
           "mamba2_forward", "mamba2_decode", "init_mamba_state"]


class MambaState(NamedTuple):
    conv: torch.Tensor   # [B, conv_dim, d_conv]  rolling conv window
    ssm: torch.Tensor    # m1: [B, d_inner, d_state]; m2: see init_mamba_state


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _slice(t, dim: int, start: int, stop=None, step: int = 1):
    idx = [slice(None)] * t.dim()
    idx[dim] = slice(start, stop, step)
    return t[tuple(idx)]


def _interleave(a, b, dim: int):
    """``a`` at the even and ``b`` at the odd positions of ``dim``
    (``a`` as long as ``b`` or one longer)."""
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    idx = [slice(None)] * a.dim()
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def associative_scan(fn, elems, dim: int):
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` under
    the associative ``fn(left, right)``: ``jax.lax.associative_scan``'s
    recursion (combine adjacent pairs, scan those, then fill in the even
    positions), so every output is combined from the same pairs in the same
    order as the reference's."""
    n = elems[0].shape[dim]
    if n < 2:
        return tuple(elems)
    reduced = fn(tuple(_slice(e, dim, 0, n - 1, 2) for e in elems),
                 tuple(_slice(e, dim, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(_slice(e, dim, 0, -1) for e in odd),
                  tuple(_slice(e, dim, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(_slice(e, dim, 2, None, 2) for e in elems))
    even = [torch.cat([_slice(e, dim, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _pad_chunks(a, pad: int):
    """``a`` [B, S, ...] with ``pad`` zero rows after S."""
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))


# ====================================================================== mamba1
def mamba1_params(gen, cfg: ModelConfig, dtype=None) -> Params:
    dtype = dtype or cfg.dtype
    d, di, ds, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dtr
    dev = gen.device
    A = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(di, ds)
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype=dtype),
        "conv_w": dense_init(gen, cfg.d_conv, di, dtype=dtype) * 0.5,
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, di, dtr + 2 * ds, dtype=dtype),
        "dt_w": dense_init(gen, dtr, di, dtype=dtype),
        "dt_b": torch.full((di,), -4.6, dtype=torch.float32, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, dtype=dtype),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x [B,S,C], w [K,C]. Returns (y, new_state)
    where state [B,C,K] holds the last K inputs (for decode continuation).
    The K taps are summed in the reference's order."""
    S = x.shape[1]
    K = w.shape[0]
    if state is None:
        xp = DT.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.transpose(1, 2)[:, -(K - 1):], x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(K)) + b
    # a copy, not a view: a prefill keeps every layer's state
    new_state = xp[:, -K:].transpose(1, 2).contiguous() if S >= 1 else state
    return y, new_state


def _conv_step(conv, w, b):
    """One decode step of :func:`_causal_conv`: the window conv [B,C,K]
    against w [K,C], the taps summed in the same order and dtype as the
    forward sums them, so the step rounds as the forward does at that
    position. (The reference's ``einsum("bck,kc->bc")`` rounds once; in
    bf16 its decode then drifts from its forward by an ulp of the conv a
    layer a step, ~0.15 of the logits after one step through
    falcon-mamba-7b's 64 layers.)"""
    return sum(conv[:, :, i] * w[i] for i in range(w.shape[0])) + b


def _m1_combine(l, r):
    return r[0] * l[0], r[0] * l[1] + r[1]


def mamba1_forward(p: Params, cfg: ModelConfig, x, state: MambaState = None,
                   chunk: int = 256) -> Tuple[torch.Tensor, MambaState]:
    """x [B,S,d] -> (y [B,S,d], final_state): :func:`mamba1_inputs` (the
    input projections and the conv), :func:`mamba1_scan` (the chunked
    selective scan) and :func:`mamba1_output` (the gate and the output
    projection)."""
    ins = mamba1_inputs(p, cfg, x, None if state is None else state.conv)
    h0 = None if state is None else state.ssm
    y, h = _channels(lambda A_log, dt, Bp, Cp, xf, h0, chunk: mamba1_scan(
        cfg, A_log, dt, Bp, Cp, xf, h0, chunk), (p["A_log"], *ins[:4], h0),
        (0, 2, None, None, 2, 1), (0,), (2, 1), cfg.d_inner, chunk)
    return mamba1_output(p, cfg, x, y, ins, h)


def _channels(fn, args, ch_dims, weights, out_ch_dims, n_ch: int,
              chunk: int):
    """``fn(*args, chunk)``, a scan independent across batch rows (dim 0
    of every argument but the weights, those at the indices ``weights``)
    and channels (``ch_dims[i]``: the channel dim of ``args[i]``, None for
    one it does not have, e.g. B and C). For
    DTensors, on each rank's rows and, over every other mesh dim that
    divides the ``n_ch`` channels, its channels: DTensor's own choices
    inside a scan gather whole states. The outputs are placed by their
    channel dims ``out_ch_dims``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = next((a for i, a in enumerate(args)
              if i not in weights and isinstance(a, DTensor)), None)
    if x is None:
        return fn(*args, chunk)
    mesh = x.device_mesh
    weight = [i in weights for i in range(len(args))]
    in_pl = [[] for _ in args]
    grad_pl = [[] for _ in args]
    out_pl = [[] for _ in out_ch_dims]
    for md, p in enumerate(batch_placements(x)):
        batch = not p.is_replicate()
        ch = not batch and n_ch % mesh.size(md) == 0
        for i, (d, w) in enumerate(zip(ch_dims, weight)):
            if batch:
                pl = Replicate() if w else Shard(0)
                g = Partial() if w else Shard(0)
            elif ch and d is not None:
                pl = g = Shard(d)
            else:
                pl = Replicate()
                g = Partial() if ch else Replicate()
            in_pl[i].append(pl)
            grad_pl[i].append(g)
        for j, d in enumerate(out_ch_dims):
            out_pl[j].append(Shard(0) if batch else
                             Shard(d) if ch else Replicate())
    return local_call(lambda *a: fn(*a, chunk), args, in_pl, out_pl,
                      grad_pl)


def mamba1_inputs(p: Params, cfg: ModelConfig, x, conv_state=None):
    """-> (dt, B, C, x) float32 [B,S,di|ds|ds|di] for the scan, the gate z
    and the new conv window."""
    di, ds, dtr = cfg.d_inner, cfg.ssm_state, cfg.dtr
    xz = x @ p["in_proj"]
    xm, z = xz[..., :di], xz[..., di:]
    xm, conv_state = _causal_conv(xm, p["conv_w"], p["conv_b"], conv_state)
    xm = F.silu(xm)
    dbl = xm @ p["x_proj"]
    dt = _softplus(dbl[..., :dtr] @ p["dt_w"] + p["dt_b"]).float()  # [B,S,di]
    Bp = dbl[..., dtr:dtr + ds].float()                             # [B,S,ds]
    Cp = dbl[..., dtr + ds:].float()
    return dt, Bp, Cp, xm.float(), z, conv_state


def mamba1_scan(cfg: ModelConfig, A_log, dt, Bp, Cp, xf, h0=None,
                chunk: int = 256):
    """The selective scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t =
    C_t h_t, a chunk of ``chunk`` tokens at a time (S padded with dt = 0 to
    whole chunks, which leaves the state as it was). -> (y [B,S,di], final
    state [B,di,ds]), float32."""
    B, S, di = xf.shape
    ds = Bp.shape[-1]
    A = -torch.exp(A_log)                                        # [di,ds]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    dt_c = _pad_chunks(dt, pad).reshape(B, nc, Q, di)
    B_c = _pad_chunks(Bp, pad).reshape(B, nc, Q, ds)
    C_c = _pad_chunks(Cp, pad).reshape(B, nc, Q, ds)
    x_c = _pad_chunks(xf, pad).reshape(B, nc, Q, di)
    h = (torch.zeros((B, di, ds), dtype=torch.float32, device=xf.device)
         if h0 is None else h0.float())
    ys = []
    for c in range(nc):
        dtq, bq, cq, xq = dt_c[:, c], B_c[:, c], C_c[:, c], x_c[:, c]
        dBx = (dtq * xq)[..., None] * bq[:, :, None, :]         # [B,Q,di,ds]
        if cfg.ssm_scan == "cumsum":
            # log-space prefix form: h_t = e^{L_t}(h0 + sum e^{-L_τ} u_τ),
            # exponents clipped at ±60
            L = torch.cumsum(dtq[..., None] * A, dim=1)          # [B,Q,di,ds]
            w = torch.exp(torch.clamp(-L, max=60.0))
            acc = torch.cumsum(w * dBx, dim=1)
            hs = torch.exp(torch.clamp(L, min=-60.0)) * (h[:, None] + acc)
        else:
            dA = torch.exp(dtq[..., None] * A)                   # [B,Q,di,ds]
            accA, acc = associative_scan(_m1_combine, (dA, dBx), dim=1)
            hs = accA * h[:, None] + acc                         # [B,Q,di,ds]
        ys.append(torch.einsum("bqds,bqs->bqd", hs, cq))
        h = hs[:, -1]
        del hs
    # h is a view of the last chunk's [B,Q,di,ds] states: keep a copy
    return torch.stack(ys, dim=1).reshape(B, nc * Q, di)[:, :S], h.clone()


def mamba1_output(p: Params, cfg: ModelConfig, x, y, ins, h):
    """The scan's y plus D x, gated by silu(z), projected out; the final
    state. ``ins`` is :func:`mamba1_inputs`' tuple."""
    xf, z, conv_state = ins[3:]
    y = y + xf * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], cfg.d_inner, cfg.d_conv),
                                 dtype=x.dtype, device=x.device)
    return out, MambaState(conv_state.to(x.dtype), h.float())


def mamba1_decode(p: Params, cfg: ModelConfig, x, state: MambaState,
                  ) -> Tuple[torch.Tensor, MambaState]:
    """x [B,1,d]; O(1) recurrence step."""
    di, ds, dtr = cfg.d_inner, cfg.ssm_state, cfg.dtr
    xz = x[:, 0] @ p["in_proj"]
    xm, z = xz[..., :di], xz[..., di:]
    conv = torch.cat([state.conv[:, :, 1:], xm[:, :, None]], dim=-1)
    xm = _conv_step(conv, p["conv_w"], p["conv_b"])
    xm = F.silu(xm)
    dbl = xm @ p["x_proj"]
    dt = _softplus(dbl[..., :dtr] @ p["dt_w"] + p["dt_b"]).float()
    Bp = dbl[..., dtr:dtr + ds].float()
    Cp = dbl[..., dtr + ds:].float()
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)                            # [B,di,ds]
    h = dA * state.ssm + (dt * xm.float())[..., None] * Bp[:, None, :]
    y = torch.einsum("bds,bs->bd", h, Cp) + xm.float() * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    return (y @ p["out_proj"])[:, None], MambaState(conv, h)


# ====================================================================== mamba2
def mamba2_params(gen, cfg: ModelConfig, dtype=None) -> Params:
    dtype = dtype or cfg.dtype
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.n_ssm_heads
    conv_dim = di + 2 * ds
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * ds + nh, dtype=dtype),
        "conv_w": dense_init(gen, cfg.d_conv, conv_dim, dtype=dtype) * 0.5,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "dt_b": torch.full((nh,), -4.6, dtype=torch.float32, device=dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm_w": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, d, dtype=dtype),
    }


def _m2_combine(l, r):
    aL, sL = l
    aR, sR = r
    return aR * aL, aR[..., None, None] * sL + sR


def mamba2_forward(p: Params, cfg: ModelConfig, x, state: MambaState = None,
                   chunk: int = 128) -> Tuple[torch.Tensor, MambaState]:
    """SSD block decomposition. x [B,S,d] -> (y [B,S,d], final_state with
    ssm [B, nh, ds, hp])."""
    B, S, d = x.shape
    di, ds = cfg.d_inner, cfg.ssm_state
    nh, hp = cfg.n_ssm_heads, cfg.ssm_headdim
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * ds]
    dt = _softplus(zxbcdt[..., -nh:].float() + p["dt_b"])       # [B,S,nh]
    conv_state = None if state is None else state.conv
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xm = xbc[..., :di].reshape(B, S, nh, hp)
    Bp = xbc[..., di:di + ds].float()                            # [B,S,ds]
    Cp = xbc[..., di + ds:].float()
    h0 = None if state is None else state.ssm.float()
    y, hT = _channels(_ssd, (xm, dt, Bp, Cp, p["A_log"], p["D"], h0),
                      (2, 2, None, None, 0, 0, 1), (4, 5), (2, 1), nh, chunk)
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if conv_state is None:
        conv_state = torch.zeros((B, di + 2 * ds, cfg.d_conv), dtype=x.dtype,
                                 device=x.device)
    return out, MambaState(conv_state.to(x.dtype), hT)


def _ssd(xm, dt, Bp, Cp, A_log, D, h0, chunk: int):
    """mamba2's SSD over xm [B,S,nh,hp] (dt [B,S,nh], B and C [B,S,ds],
    A_log and D [nh], h0 [B,nh,ds,hp] or None) -> (y [B,S,nh,hp] float32
    with D x added, the final state [B,nh,ds,hp])."""
    B, S, nh, hp = xm.shape
    ds = Bp.shape[-1]
    A = -torch.exp(A_log)                                        # [nh]
    dA = dt * A                                                  # log decay

    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    dA_c = _pad_chunks(dA, pad).reshape(B, nc, Q, nh)
    dt_c = _pad_chunks(dt, pad).reshape(B, nc, Q, nh)
    x_c = _pad_chunks(xm.float(), pad).reshape(B, nc, Q, nh, hp)
    B_c = _pad_chunks(Bp, pad).reshape(B, nc, Q, ds)
    C_c = _pad_chunks(Cp, pad).reshape(B, nc, Q, ds)

    cum = torch.cumsum(dA_c, dim=2)                              # [B,nc,Q,nh]
    # ---- intra-chunk (attention-like, exact for τ<=t) ----
    Lmat = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,nc,Q,Q,nh]
    ar = torch.arange(Q, device=xm.device)
    tri = ar[:, None] >= ar[None, :]
    decay = torch.where(tri[None, None, :, :, None], torch.exp(Lmat), 0.0)
    del Lmat
    G = torch.einsum("bnts,bnqs->bntq", C_c, B_c)                # [B,nc,Q,Q]
    M = G[..., None] * decay                                     # [B,nc,Q,Q,nh]
    del decay
    M = M * dt_c[:, :, None, :, :]                               # dt into B·x
    y_intra = torch.einsum("bntqh,bnqhp->bnthp", M, x_c)
    del M
    # ---- chunk states ----
    last = cum[:, :, -1:, :]                                     # [B,nc,1,nh]
    sdecay = torch.exp(last - cum)                               # [B,nc,Q,nh]
    Sc = torch.einsum("bnqs,bnqh,bnqhp->bnhsp",
                      B_c, sdecay * dt_c, x_c)                   # [B,nc,nh,ds,hp]
    # ---- inter-chunk recurrence over nc ----
    if h0 is None:
        h0 = torch.zeros((B, nh, ds, hp), dtype=torch.float32,
                         device=xm.device)
    cdecay = torch.exp(last[:, :, 0, :])                         # [B,nc,nh]
    accA, accS = associative_scan(_m2_combine, (cdecay, Sc), dim=1)
    # the state entering chunk n: the earlier chunks' decay of h0 + states
    accA_prev = torch.cat([torch.ones_like(accA[:, :1]), accA[:, :-1]], dim=1)
    accS_prev = torch.cat([torch.zeros_like(accS[:, :1]), accS[:, :-1]],
                          dim=1)
    h_in = accA_prev[..., None, None] * h0[:, None] + accS_prev  # [B,nc,nh,ds,hp]
    # ---- inter-chunk contribution to outputs ----
    edecay = torch.exp(cum)                                      # from chunk start
    y_inter = torch.einsum("bnqs,bnqh,bnhsp->bnqhp", C_c, edecay, h_in)
    y = (y_intra + y_inter).reshape(B, nc * Q, nh, hp)[:, :S]
    y = y + xm.float() * D[None, None, :, None]
    return y, accA[:, -1][..., None, None] * h0 + accS[:, -1]


def mamba2_decode(p: Params, cfg: ModelConfig, x, state: MambaState,
                  ) -> Tuple[torch.Tensor, MambaState]:
    di, ds = cfg.d_inner, cfg.ssm_state
    nh, hp = cfg.n_ssm_heads, cfg.ssm_headdim
    B = x.shape[0]
    zxbcdt = x[:, 0] @ p["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * ds]
    dt = _softplus(zxbcdt[..., -nh:].float() + p["dt_b"])
    conv = torch.cat([state.conv[:, :, 1:], xbc[:, :, None]], dim=-1)
    xbc = _conv_step(conv, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc)
    xm = xbc[..., :di].reshape(B, nh, hp).float()
    Bp = xbc[..., di:di + ds].float()
    Cp = xbc[..., di + ds:].float()
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                        # [B,nh]
    h = a[..., None, None] * state.ssm \
        + torch.einsum("bh,bs,bhp->bhsp", dt, Bp, xm)
    y = torch.einsum("bs,bhsp->bhp", Cp, h) + xm * p["D"][None, :, None]
    y = y.reshape(B, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None], MambaState(conv, h)


def init_mamba_state(cfg: ModelConfig, B: int, n_layers: int,
                     dtype=torch.bfloat16, device=None) -> MambaState:
    """Zero states ``[n_layers, B, ...]`` on ``device`` (the card when
    None): the conv window in ``dtype``, the ssm state float32 — for mamba2
    ``[nh, hp, ds]`` as the reference makes it, although its forward and
    decode keep ``[nh, ds, hp]`` (a reference fault, ROADMAP queue 3: a
    decode from this state fails where ``hp != ds``)."""
    if cfg.ssm_version == 1:
        conv_dim, ssm_shape = cfg.d_inner, (cfg.d_inner, cfg.ssm_state)
    else:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        ssm_shape = (cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    dev = torch.device("cuda" if device is None else device)
    return MambaState(
        torch.zeros((n_layers, B, conv_dim, cfg.d_conv), dtype=dtype,
                    device=dev),
        torch.zeros((n_layers, B) + ssm_shape, dtype=torch.float32,
                    device=dev))
