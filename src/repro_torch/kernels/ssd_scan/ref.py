"""Plain PyTorch version of the SSD chunk-scan kernel (K4).

Counterpart of ``repro.kernels.ssd_scan.ref.ssd_ref``, which is
``repro.models.mamba2.ssd``: the chunked state-space-duality scan of
Mamba2, followed op for op — f32 throughout, the sequence padded with
``dt = 0`` (no-op steps) to a multiple of the chunk ``Q = min(chunk, T)``,
and a loop over chunks carrying the state S.  Contract:

  x:          (b, T, nh, P)   values
  dt:         (b, T, nh)      step sizes (softplus applied; 0 = no-op)
  A:          (nh,)           negative
  Bm, Cm:     (b, T, G, N)    input / output projections; head h reads
                              group h // (nh/G)
  init_state: (b, nh, P, N) or None (zeros)
  -> y (b, T, nh, P) in x's dtype, final state (b, nh, P, N) f32

A row whose every ``dt`` is 0 leaves its state exactly as it was
(``exp(0) = 1`` and a zero contribution), which the engine relies on for
inactive slots and padded tokens.  ``calls`` counts calls, so that a run
on the card can show that its main path never took the plain version.

``ssd_split_ref`` is the plain version of the kernel's own decomposition
on one of its routes (what ``ops.launch_on_route`` runs for CPU tensors):
the state's rows cut into ``n_split`` slices, each computed alone, in one
pass per token on the recurrent route and in chunks on the others.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

calls = {"ssd": 0}

# the form each of the kernel's routes computes: T steps of the one-pass
# recurrence, or chunks of Q = min(chunk, T) as ``ssd_ref``
FORMS = {"recurrent": "one_pass", "tensor_cores": "chunked",
         "cuda_cores": "chunked"}


def segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA (..., Q) -> (..., Q, Q): out[i, j] = sum_{j<k<=i} dA_k for
    i >= j, -inf above the diagonal."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, seg, float("-inf"))


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor,
            init_state: Optional[torch.Tensor], chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    calls["ssd"] += 1
    b, T, nh, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = nh // G
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))                 # dt=0 -> no-op steps
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Tp = T + pad
    nc = Tp // Q

    f32 = torch.float32
    xc = x.reshape(b, nc, Q, nh, Pd).to(f32)
    dtc = dt.reshape(b, nc, Q, nh).to(f32)
    Bc = Bm.reshape(b, nc, Q, G, N).to(f32)
    Cc = Cm.reshape(b, nc, Q, G, N).to(f32)
    dA = dtc * A.to(f32)[None, None, None, :]          # (b,nc,Q,nh)

    S = (torch.zeros((b, nh, Pd, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    ys = []
    for c in range(nc):
        xq, dtq, dAq = xc[:, c], dtc[:, c], dA[:, c]
        Bh = Bc[:, c].repeat_interleave(Hg, dim=2)     # (b,Q,nh,N)
        Ch = Cc[:, c].repeat_interleave(Hg, dim=2)
        cs = torch.cumsum(dAq, dim=1)                  # (b,Q,nh) inclusive
        # intra-chunk (quadratic) term
        L = torch.exp(segsum(dAq.transpose(1, 2)))     # (b,nh,Q,Q)
        CB = torch.einsum("bihn,bjhn->bhij", Ch, Bh)
        W = CB * L * dtq.transpose(1, 2)[:, :, None, :]
        y_diag = torch.einsum("bhij,bjhp->bihp", W, xq)
        # contribution of the incoming state
        y_off = torch.einsum("bihn,bhpn->bihp", Ch, S) \
            * torch.exp(cs)[..., None]
        # new state
        total = cs[:, -1, :]                           # (b,nh)
        decay_out = torch.exp(total[:, None, :] - cs)  # (b,Q,nh)
        S_local = torch.einsum("bjhn,bjhp,bjh->bhpn", Bh, xq,
                               dtq * decay_out)
        S = torch.exp(total)[:, :, None, None] * S + S_local
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(b, Tp, nh, Pd)[:, :T]
    return y.to(x.dtype), S


def _dot_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] * b[..., k], one term at a time in k's order: each
    output's bits depend on its own operands only, not on the slice of
    the tensor it lies in."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1],
                      dtype=torch.float32, device=a.device)
    for k in range(a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


def _ssd_slice(x, dt, A, Bh, Ch, S, Q):
    """One slice of the state's rows: x (b,Tp,nh,Pt) f32 padded to whole
    chunks of Q, dt (b,Tp,nh), Bh / Ch (b,Tp,nh,N) per head, S
    (b,nh,Pt,N).  In the kernel's order: y starts from exp(cs_i) (C_i
    S^T) and adds the weighted keys j = 0, 1, ... one at a time; the
    state is decayed, then the keys' terms are added in order."""
    b, Tp, nh, Pt = x.shape
    ys = []
    for t0 in range(0, Tp, Q):
        xq, dtq = x[:, t0:t0 + Q], dt[:, t0:t0 + Q]
        Bq, Cq = Bh[:, t0:t0 + Q], Ch[:, t0:t0 + Q]
        cs = torch.cumsum(dtq * A, dim=1)                   # (b,Q,nh)
        # exp(cs_i) (C_i S^T): (b,Q,nh,1,N) . (b,1,nh,Pt,N)
        y = _dot_in_order(Cq[:, :, :, None, :], S[:, None]) \
            * torch.exp(cs)[..., None]
        cb = _dot_in_order(Cq[:, :, None], Bq[:, None])      # (b,i,j,nh)
        for j in range(Q):
            w = cb[:, :, j] * torch.exp(cs - cs[:, j:j + 1]) \
                * dtq[:, j:j + 1]                            # (b,i,nh)
            w = torch.where(torch.arange(Q, device=w.device)[None, :, None]
                            >= j, w, 0.0)
            y = y + w[..., None] * xq[:, j:j + 1]
        total = cs[:, -1]                                    # (b,nh)
        S = torch.exp(total)[..., None, None] * S
        for j in range(Q):
            bw = Bq[:, j] * (dtq[:, j] * torch.exp(total - cs[:, j]))[
                ..., None]                                   # (b,nh,N)
            S = S + xq[:, j][..., None] * bw[:, :, None, :]
        ys.append(y)
    return torch.cat(ys, dim=1), S


def _one_pass(x, dt, A, Bh, Ch, S):
    """One slice of the state's rows, one token at a time, in the recurrent
    route's order: x (b,T,nh,Pt), dt (b,T,nh), Bh / Ch (b,T,nh,N) per
    head, S (b,nh,Pt,N); S <- exp(dt_t A) S + (dt_t x_t) (x) B_t, then
    y_t = S . C_t."""
    ys = []
    for t in range(x.shape[1]):
        u = dt[:, t, :, None] * x[:, t]                      # (b,nh,Pt)
        S = u[..., None] * Bh[:, t, :, None, :] \
            + torch.exp(dt[:, t] * A)[..., None, None] * S
        ys.append(_dot_in_order(S, Ch[:, t, :, None, :]))
    return torch.stack(ys, dim=1), S


def ssd_split_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor,
                  init_state: Optional[torch.Tensor], chunk: int,
                  n_split: int = 1, route: str = "recurrent"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_ref``'s function computed as the kernel decomposes it on
    ``route`` (a key of ``FORMS``): the state's P rows in ``n_split``
    contiguous slices, each from its own x[..., p] and S[p, :] and the
    weights every slice recomputes, so the result is bitwise independent
    of ``n_split``.  The recurrent route takes one pass per token,

        S_new = exp(dt A) S + (dt x) (x) B,    y = S_new . C,

    the others chunks of Q = min(chunk, T) as ``ssd_ref``.  f32
    throughout; y in x's dtype."""
    b, T, nh, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if route not in FORMS:
        raise ValueError(f"ssd_split_ref: no route {route!r}; want one of "
                         f"{sorted(FORMS)}")
    if Pd % n_split:
        raise ValueError(f"ssd_split_ref: P={Pd} not divisible by "
                         f"{n_split}")
    f32 = torch.float32
    Q = T if FORMS[route] == "one_pass" else min(chunk, T)
    pad = (-T) % Q
    xf = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.to(f32), (0, 0, 0, pad))
    Bh = F.pad(Bm.to(f32), (0, 0, 0, 0, 0, pad)).repeat_interleave(
        nh // G, dim=2)
    Ch = F.pad(Cm.to(f32), (0, 0, 0, 0, 0, pad)).repeat_interleave(
        nh // G, dim=2)
    A = A.to(f32)
    S0 = (torch.zeros((b, nh, Pd, N), dtype=f32, device=x.device)
          if init_state is None else init_state.to(f32))
    Pt = Pd // n_split
    ys, Ss = [], []
    for p0 in range(0, Pd, Pt):
        xs, Ss0 = xf[..., p0:p0 + Pt], S0[:, :, p0:p0 + Pt]
        if FORMS[route] == "one_pass":
            y, S = _one_pass(xs, dtf, A, Bh, Ch, Ss0)
        else:
            y, S = _ssd_slice(xs, dtf, A, Bh, Ch, Ss0, Q)
        ys.append(y[:, :T])
        Ss.append(S)
    return torch.cat(ys, dim=-1).to(x.dtype), torch.cat(Ss, dim=2)
