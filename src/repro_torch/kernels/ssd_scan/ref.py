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

``ssd_bwd_ref`` is the plain version of K4's backward (the port adds it:
the JAX package differentiates its plain ``ssd`` by autodiff): the same
chunked backward the kernel computes, written out op by op, not a call
to autograd.  ``calls["ssd_bwd"]`` counts its calls.

``ssd_split_ref`` is the plain version of the kernel's own decomposition
on one of its routes (what ``ops.launch_on_route`` runs for CPU tensors):
the state's rows cut into ``n_split`` slices, each computed alone, in one
pass per token on the recurrent route and in chunks on the others.
``ssd_bwd_split_ref`` is the same for K4's backward (what
``ops.launch_bwd_on_route`` runs for CPU tensors): group-level C B^T, M
summed over the group's heads in head order, causal in-range tiles of 64
steps only, and on the tensor-core route the hi/lo bf16 rounding of the
f32 operands.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

calls = {"ssd": 0, "ssd_bwd": 0}

# the backward's routes
BWD_ROUTES = ("tensor_cores", "cuda_cores")
# the backward's block of a chunk's steps, a tile's side
BLOCK = 64

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


def _chunk_states(xc, dyc, dtc, Bh, Ch, cs, init_state, dstate):
    """Each chunk's input state S_c and the gradient dS_c of its output
    state, and dinit (None without an initial state), from per-chunk f32
    x, dy (b,nc,Q,nh,P), dt, cs (b,nc,Q,nh) and per-head B, C
    (b,nc,Q,nh,N)."""
    b, nc, _, nh, Pd = xc.shape
    N = Bh.shape[-1]
    f32, last = torch.float32, cs[:, :, -1]
    S = (torch.zeros((b, nh, Pd, N), dtype=f32, device=xc.device)
         if init_state is None else init_state.to(f32))
    states = []
    for c in range(nc):
        states.append(S)
        w = dtc[:, c] * torch.exp(last[:, c, None] - cs[:, c])
        S = torch.exp(last[:, c])[..., None, None] * S + torch.einsum(
            "bjhn,bjhp,bjh->bhpn", Bh[:, c], xc[:, c], w)
    dS = (torch.zeros((b, nh, Pd, N), dtype=f32, device=xc.device)
          if dstate is None else dstate.to(f32))
    dstates = [None] * nc
    for c in reversed(range(nc)):
        dstates[c] = dS
        dS = torch.exp(last[:, c])[..., None, None] * dS + torch.einsum(
            "bihp,bihn,bih->bhpn", dyc[:, c], Ch[:, c], torch.exp(cs[:, c]))
    return states, dstates, (dS if init_state is not None else None)


def ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor,
                init_state: Optional[torch.Tensor], chunk: int,
                dy: torch.Tensor, dstate: Optional[torch.Tensor] = None):
    """Gradients of ``ssd_ref``'s (y, final state) -> (dx in x's dtype,
    ddt, dA, dBm, dCm f32, dinit f32 or None).  ``dy`` (b,T,nh,P) is
    y's gradient, ``dstate`` (b,nh,P,N) or None (zero) the final
    state's; ``dinit`` is made only when ``init_state`` is given.

    Per chunk of Q tokens, with a_k = dt_k A, cs_i = sum_{k<=i} a_k, S
    the chunk's input state and dS the gradient of its output state:

      states:  S_{c+1} = exp(cs_Q) S_c + sum_j exp(cs_Q - cs_j) dt_j x_j (x) B_j
      reverse: dS_{c-1} = exp(cs_Q) dS_c + sum_i exp(cs_i) dy_i (x) C_i
      E_ij = exp(cs_i - cs_j) [j <= i],  W = (C B^T) o E dt_j,
      M = (dy x^T) o E dt_j,  G = (C B^T) o (dy x^T) o E
      dx_j = sum_i W_ij dy_i + e2_j dt_j dS B_j        (e2_j = exp(cs_Q - cs_j))
      dB_j = sum_i M_ij C_i + e2_j dt_j x_j^T dS
      dC_i = sum_j M_ij B_j + exp(cs_i) dy_i^T S
      ddt_j = sum_i G_ij + e2_j u_j + da_j A          (u_j = x_j^T dS B_j)
      dcs_i = sum_j dt_j G_ij - dt_i sum_k G_ki + exp(cs_i) dy_i . (S C_i)
              - e2_i dt_i u_i  [+ exp(cs_Q) <dS, S> + sum_j e2_j dt_j u_j
              at the chunk's last step]
      da_k = sum_{i>=k} dcs_i,   dA = sum da_k dt_k

    B and C gradients are summed over the heads of their group.  T off
    the chunk is padded as the forward pads it (dt = 0); padded steps'
    gradients are dropped."""
    calls["ssd_bwd"] += 1
    b, T, nh, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = nh // G
    Q = min(chunk, T)
    pad = (-T) % Q
    Tp = T + pad
    nc = Tp // Q
    f32 = torch.float32

    def chunks(t, last):
        t = F.pad(t.to(f32), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((b, nc, Q) + tuple(last))

    xc = chunks(x, (nh, Pd))
    dyc = chunks(dy, (nh, Pd))
    dtc = chunks(dt, (nh,))
    Bh = chunks(Bm, (G, N)).repeat_interleave(Hg, dim=3)     # (b,nc,Q,nh,N)
    Ch = chunks(Cm, (G, N)).repeat_interleave(Hg, dim=3)
    A = A.to(f32)
    cs = torch.cumsum(dtc * A, dim=2)                          # (b,nc,Q,nh)
    last = cs[:, :, -1]                                        # (b,nc,nh)

    states, dstates, dinit = _chunk_states(xc, dyc, dtc, Bh, Ch, cs,
                                           init_state, dstate)

    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    dx, ddt, dBh, dCh = [], [], [], []
    dA = torch.zeros((nh,), dtype=f32, device=x.device)
    for c in range(nc):
        S0, dS1 = states[c], dstates[c]
        xq, dyq, dtq = xc[:, c], dyc[:, c], dtc[:, c]
        Bq, Cq, csq = Bh[:, c], Ch[:, c], cs[:, c]
        seg = csq[:, :, None, :] - csq[:, None, :, :]          # (b,i,j,h)
        E = torch.exp(torch.where(tril[None, :, :, None], seg,
                                  float("-inf")))
        CB = torch.einsum("bihn,bjhn->bijh", Cq, Bq)
        DX = torch.einsum("bihp,bjhp->bijh", dyq, xq)
        dtj = dtq[:, None]                                     # (b,1,j,h)
        W, M, Gm = CB * E * dtj, DX * E * dtj, CB * DX * E
        e2 = torch.exp(last[:, c, None] - csq)                 # (b,Q,h)
        r = torch.einsum("bhpn,bjhn->bjhp", dS1, Bq)
        dx.append(torch.einsum("bijh,bihp->bjhp", W, dyq)
                  + (e2 * dtq)[..., None] * r)
        dBh.append(torch.einsum("bijh,bihn->bjhn", M, Cq)
                   + (e2 * dtq)[..., None]
                   * torch.einsum("bjhp,bhpn->bjhn", xq, dS1))
        dCh.append(torch.einsum("bijh,bjhn->bihn", M, Bq)
                   + torch.exp(csq)[..., None]
                   * torch.einsum("bihp,bhpn->bihn", dyq, S0))
        u = (xq * r).sum(-1)                                   # (b,Q,h)
        v = (dyq * torch.einsum("bihn,bhpn->bihp", Cq, S0)).sum(-1)
        rows = (dtj * Gm).sum(2)                               # (b,i,h)
        cols = Gm.sum(1)                                       # (b,j,h)
        dcs = rows - dtq * cols + torch.exp(csq) * v - e2 * dtq * u
        dcs[:, -1] += torch.exp(last[:, c]) * (dS1 * S0).sum((-2, -1)) \
            + (e2 * dtq * u).sum(1)
        da = torch.flip(torch.cumsum(torch.flip(dcs, [1]), 1), [1])
        ddt.append(cols + e2 * u + da * A)
        dA = dA + (da * dtq).sum((0, 1))

    def whole(parts):
        return torch.stack(parts, 1).reshape((b, Tp) + parts[0].shape[2:])[
            :, :T]
    dBm = whole(dBh).reshape(b, T, G, Hg, N).sum(3)
    dCm = whole(dCh).reshape(b, T, G, Hg, N).sum(3)
    return (whole(dx).to(x.dtype), whole(ddt), dA, dBm, dCm, dinit)


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


def _hilo(t: torch.Tensor) -> torch.Tensor:
    """t as the tensor-core route feeds an f32 operand: hi + lo, each
    rounded to bf16 (about 16 bits of mantissa)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def ssd_bwd_split_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor,
                      init_state: Optional[torch.Tensor], chunk: int,
                      dy: torch.Tensor,
                      dstate: Optional[torch.Tensor] = None,
                      route: str = "cuda_cores"):
    """``ssd_bwd_ref``'s gradients computed as the kernel decomposes them
    on ``route`` (a name of ``BWD_ROUTES``): each chunk's steps in blocks
    of 64 and only its causal, in-range tiles (I, J), J <= I; per tile,
    C B^T once per group, and M = (dy x^T) o E dt_j summed over the
    group's heads in head order into Mg, whose products Mg B_J (dC) and
    Mg^T C_I (dB) are taken once per group; E_ij = exp(cs_i - cs_j) as
    f_i g_j against the first step r of row i's strip of 16 where j < r
    (both factors <= 1), directly from r to i; G's row and column sums per
    tile; dx_J = sum_I W^T(J, I) dy_I + e2 dt (dS B_J) per head; the
    boundary terms exp(cs_i) dy_i^T S (dC, with v = C . that) and
    e2_j dt_j x_j^T dS (dB, with u = B . that) summed over the group's
    heads in order.  On the tensor-core route every f32 operand of a
    product (W^T, Mg, S, dS) is rounded as the kernel feeds it, hi + lo in
    bf16.  f32 throughout; dx in x's dtype."""
    if route not in BWD_ROUTES:
        raise ValueError(f"ssd_bwd_split_ref: no route {route!r}; want one "
                         f"of {BWD_ROUTES}")
    rnd = _hilo if route == "tensor_cores" else (lambda t: t)
    b, T, nh, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = nh // G
    Q = min(chunk, T)
    pad = (-T) % Q
    nc = (T + pad) // Q
    f32 = torch.float32

    def chunks(t, last):
        t = F.pad(t.to(f32), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((b, nc, Q) + tuple(last))

    xc, dyc, dtc = chunks(x, (nh, Pd)), chunks(dy, (nh, Pd)), chunks(
        dt, (nh,))
    Bc, Cc = chunks(Bm, (G, N)), chunks(Cm, (G, N))     # per group
    A = A.to(f32)
    cs = torch.cumsum(dtc * A, dim=2)                   # (b,nc,Q,nh)
    states, dstates, dinit = _chunk_states(
        xc, dyc, dtc, Bc.repeat_interleave(Hg, dim=3),
        Cc.repeat_interleave(Hg, dim=3), cs, init_state, dstate)
    dev = x.device

    def zeros(shape):
        return torch.zeros(shape, dtype=f32, device=dev)
    dx, ddt = zeros((b, nc, Q, nh, Pd)), zeros((b, nc, Q, nh))
    dB, dC = zeros((b, nc, Q, G, N)), zeros((b, nc, Q, G, N))
    dA = zeros((nh,))
    grp = torch.arange(nh, device=dev) // Hg            # head -> group

    def head_sum(t):
        """(b, nh, ...) -> (b, G, ...), each group's heads in order."""
        t = t.reshape((b, G, Hg) + t.shape[2:])
        acc = t[:, :, 0]
        for k in range(1, Hg):
            acc = acc + t[:, :, k]
        return acc

    for c in range(nc):
        nr = min(Q, T - c * Q)
        nb = -(-nr // BLOCK)
        S0, dS1 = states[c], dstates[c]
        xq, dyq, dtq, csq = xc[:, c], dyc[:, c], dtc[:, c], cs[:, c]
        Bq, Cq = Bc[:, c], Cc[:, c]
        last = csq[:, -1]                               # (b,nh)
        e2 = torch.exp(last[:, None] - csq)             # (b,Q,nh)
        rows = [slice(k * BLOCK, min((k + 1) * BLOCK, nr)) for k in
                range(nb)]
        rs, cl = zeros((b, Q, nh)), zeros((b, Q, nh))
        for I in range(nb):
            si = rows[I]
            for J in range(I + 1):
                sj = rows[J]
                cb = torch.einsum("bign,bjgn->bgij", Cq[:, si], Bq[:, sj])
                cbh = cb[:, grp]                        # (b,nh,i,j)
                d = torch.einsum("bihp,bjhp->bhij", dyq[:, si], xq[:, sj])
                ii = torch.arange(si.start, si.stop, device=dev)[:, None]
                jj = torch.arange(sj.start, sj.stop, device=dev)[None, :]
                ci = csq[:, si].transpose(1, 2)[..., :, None]   # (b,nh,i,1)
                cj = csq[:, sj].transpose(1, 2)[..., None, :]   # (b,nh,1,j)
                # f_i g_j against the first step r of row i's 16-row
                # strip where j < r; directly from r to i; 0 past i
                cr = csq[:, ii[:, 0] // 16 * 16].transpose(1, 2)[..., None]
                E = torch.where(
                    jj < ii // 16 * 16,
                    torch.exp(ci - cr) * torch.exp(cr - cj),
                    torch.where(jj <= ii, torch.exp(ci - cj), 0.0))
                dtj = dtq[:, sj].transpose(1, 2)[:, :, None, :]
                Mg = head_sum(d * E * dtj)                  # (b,G,i,j)
                g = cbh * d * E
                rs[:, si] += (dtj * g).sum(-1).transpose(1, 2)
                cl[:, sj] += g.sum(-2).transpose(1, 2)
                dC[:, c, si] += torch.einsum("bgij,bjgn->bign", rnd(Mg),
                                             Bq[:, sj])
                dB[:, c, sj] += torch.einsum("bgij,bign->bjgn", rnd(Mg),
                                             Cq[:, si])
                W = rnd(cbh * E * dtj)
                dx[:, c, sj] += torch.einsum("bhij,bihp->bjhp", W,
                                             dyq[:, si])
        v, u = zeros((b, Q, nh)), zeros((b, Q, nh))
        for K in range(nb):
            sk = rows[K]
            Ck = Cq[:, sk].repeat_interleave(Hg, dim=2)     # (b,k,nh,N)
            Bk = Bq[:, sk].repeat_interleave(Hg, dim=2)
            zc = torch.einsum("bkhp,bhpn->bhkn", dyq[:, sk], rnd(S0))
            v[:, sk] = (Ck * zc.transpose(1, 2)).sum(-1)
            dC[:, c, sk] += head_sum(
                torch.exp(csq[:, sk]).transpose(1, 2)[..., None]
                * zc).transpose(1, 2)
            zb = torch.einsum("bkhp,bhpn->bhkn", xq[:, sk], rnd(dS1))
            u[:, sk] = (Bk * zb.transpose(1, 2)).sum(-1)
            dB[:, c, sk] += head_sum(
                (e2[:, sk] * dtq[:, sk]).transpose(1, 2)[..., None]
                * zb).transpose(1, 2)
            r = torch.einsum("bkhn,bhpn->bkhp", Bk, rnd(dS1))
            dx[:, c, sk] += (e2[:, sk] * dtq[:, sk])[..., None] * r
        dcs = rs - dtq * cl + torch.exp(csq) * v - e2 * dtq * u
        dcs[:, nr - 1] += torch.exp(last) * (dS1 * S0).sum((-2, -1)) \
            + (e2 * dtq * u).sum(1)
        da = torch.flip(torch.cumsum(torch.flip(dcs, [1]), 1), [1])
        ddt[:, c] = cl + e2 * u + da * A
        dA = dA + (da * dtq).sum((0, 1))

    def whole(t):
        return t.reshape((b, nc * Q) + t.shape[3:])[:, :T]
    return (whole(dx).to(x.dtype), whole(ddt), dA, whole(dB), whole(dC),
            dinit)
