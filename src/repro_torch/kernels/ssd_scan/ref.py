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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

calls = {"ssd": 0}


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
