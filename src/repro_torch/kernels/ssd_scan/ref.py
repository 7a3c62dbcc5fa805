"""Plain-torch Mamba-2 SSD (state-space duality) pieces, the twins of
`repro.kernels.ssd_scan.ref`, plus the plain versions of the two CUDA
kernels of this directory.

Shapes of the full scan:
  x  : (B, S, H, P)   inputs per head
  dt : (B, S, H)      softplus'd step sizes
  A  : (H,)           negative per-head decay rates
  Bm : (B, S, G, N)   input matrices (G groups broadcast over heads)
  Cm : (B, S, G, N)   output matrices
Returns (y, final_state) with y: (B, S, H, P), final_state: (B, H, P, N).

The intra-chunk pass (`ssd_intra_plain`, kernel 6's function) works on the
chunked layout of `repro.kernels.ssd_scan.kernel.ssd_intra_pallas`:
x (B, H, nc, Q, P), dt (B, H, nc, Q, 1), A (H,), Bm / Cm (B, G, nc, Q, N),
all f32; the group of head h is h * G // H.
"""
from __future__ import annotations

import torch


def _segsum_exp(cs):
    """cs: (..., Q) inclusive cumsums -> (..., Q, Q) with
    L[i, j] = exp(cs_i - cs_j) for i >= j and 0 above the diagonal.  The
    mask is applied before ``exp``: above the diagonal the difference is
    large and positive, and exp would overflow."""
    Q = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=cs.device).tril()
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def _heads_of_groups(t, H, dim):
    """Index the group axis ``dim`` of ``t`` by h * G // H for h < H."""
    G = t.shape[dim]
    grp = torch.arange(H, device=t.device) * G // H
    return t.index_select(dim, grp)


def ssd_reference(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """The whole chunked scan in plain ops (`ref.ssd_reference`)."""
    B_, S, H, P = x.shape
    N = Bm.shape[3]
    nc = S // chunk
    assert nc * chunk == S, f"seq {S} not divisible by chunk {chunk}"
    f32 = torch.float32
    x, dt = x.to(f32), dt.to(f32)
    Bh = _heads_of_groups(Bm.to(f32), H, 2)         # (B,S,H,N)
    Ch = _heads_of_groups(Cm.to(f32), H, 2)
    xc = x.reshape(B_, nc, chunk, H, P)
    dtc = dt.reshape(B_, nc, chunk, H)
    Bc = Bh.reshape(B_, nc, chunk, H, N)
    Cc = Ch.reshape(B_, nc, chunk, H, N)

    dA_h = (dtc * A.to(f32)).movedim(-1, 2)          # (B,nc,H,Q)
    cs = torch.cumsum(dA_h, dim=-1)
    L = _segsum_exp(cs)                              # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc) * L
    xdt = xc * dtc[..., None]                        # (B,nc,Q,H,P)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt)

    decay_to_end = torch.exp(cs[..., -1:] - cs)      # (B,nc,H,Q)
    states = torch.einsum("bchq,bcqhn,bcqhp->bchpn", decay_to_end, Bc, xdt)
    chunk_decay = torch.exp(cs[..., -1])             # (B,nc,H)
    h = (torch.zeros(B_, H, P, N, dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_starts = torch.stack(starts, 1)                # (B,nc,H,P,N)
    y_inter = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Cc, h_starts,
                           torch.exp(cs))
    return (y_intra + y_inter).reshape(B_, S, H, P), h


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One recurrent step (`ref.ssd_decode_step`).  state: (B,H,P,N);
    x_t: (B,H,P); dt_t: (B,H); B_t, C_t: (B,G,N).  Returns (y (B,H,P),
    new_state), both f32."""
    H = x_t.shape[1]
    f32 = torch.float32
    B_t = _heads_of_groups(B_t.to(f32), H, 1)         # (B,H,N)
    C_t = _heads_of_groups(C_t.to(f32), H, 1)
    dt_t = dt_t.to(f32)
    dA = torch.exp(dt_t * A.to(f32)[None, :])         # (B,H)
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dt_t, B_t, x_t.to(f32))
    new_state = state.to(f32) * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bhn->bhp", new_state, C_t)
    return y, new_state


# ---------------------------------------------------------------------------
# kernel 6 and its gradient: plain versions
# ---------------------------------------------------------------------------

def ssd_intra_plain(x, dt, A, Bm, Cm):
    """Plain version of kernel 6 (`ssd_intra_pallas`): per (b, h, chunk)
    cs = cumsum(dt * A), y = ((C B^T) o L)(x dt) with
    L_ij = exp(cs_i - cs_j) for i >= j, state = (x dt exp(cs_Q - cs))^T B.
    Returns (y_intra (B,H,nc,Q,P), states (B,H,nc,P,N), cs (B,H,nc,Q,1))."""
    H = x.shape[1]
    Bh = _heads_of_groups(Bm, H, 1)                   # (B,H,nc,Q,N)
    Ch = _heads_of_groups(Cm, H, 1)
    cs = torch.cumsum(dt * A[None, :, None, None, None], dim=3)
    L = _segsum_exp(cs[..., 0])                       # (B,H,nc,Q,Q)
    u = x * dt
    y = ((Ch @ Bh.transpose(-1, -2)) * L) @ u
    w = torch.exp(cs[..., -1:, :] - cs)               # (B,H,nc,Q,1)
    states = (u * w).transpose(-1, -2) @ Bh
    return y, states, cs


def _sum_heads_into_groups(t, G):
    """(B, H, ...) per-head gradients -> (B, G, ...) sums over each
    group's heads (head h belongs to group h * G // H)."""
    B_, H = t.shape[:2]
    if G == H:
        return t
    grp = torch.arange(H, device=t.device) * G // H
    out = t.new_zeros((B_, G) + tuple(t.shape[2:]))
    return out.index_add_(1, grp, t)


def ssd_intra_bwd_plain(x, dt, A, Bm, Cm, cs, gy, gst, gcs):
    """Plain version of the backward kernel: the gradient of
    `ssd_intra_plain` at (x, dt, A, Bm, Cm) given the output gradients
    gy (B,H,nc,Q,P), gst (B,H,nc,P,N), gcs (B,H,nc,Q,1), in explicit
    formulas.  With u = x dt, G = C B^T, S = G o L and
    w_j = exp(cs_last - cs_j), per block:

        gS  = (gy u^T) masked to i >= j
        gu  = S^T gy + w o (B gst^T)
        gC  = (gS o L) B,   gB = (gS o L)^T C + w o (u gst)
        R   = gS o S:  gcs_i += sum_j R_ij,  gcs_j -= sum_i R_ij
        gw_j = sum_p u_jp (B gst^T)_jp:  gcs_j -= gw_j w_j,
                                        gcs_last += sum_j gw_j w_j
        gdA = reverse cumsum of gcs;  gdt = gdA A + rowsum(gu o x)
        gx  = gu dt;  gA = sum gdA dt over b, chunk and t

    gB and gC are summed over the heads of each group.  Returns
    (gx, gdt, gA, gB, gC) in the shapes of the inputs."""
    H, G = x.shape[1], Bm.shape[1]
    Bh = _heads_of_groups(Bm, H, 1)
    Ch = _heads_of_groups(Cm, H, 1)
    c = cs[..., 0]                                    # (B,H,nc,Q)
    L = _segsum_exp(c)
    u = x * dt
    S = (Ch @ Bh.transpose(-1, -2)) * L
    w = torch.exp(c[..., -1:] - c)[..., None]         # (B,H,nc,Q,1)
    gS = (gy @ u.transpose(-1, -2)).tril()
    Bg = Bh @ gst.transpose(-1, -2)                   # (B,H,nc,Q,P)
    gu = S.transpose(-1, -2) @ gy + w * Bg
    gG = gS * L
    gC = gG @ Bh
    gB = gG.transpose(-1, -2) @ Ch + w * (u @ gst)
    R = gS * S
    g = gcs[..., 0] + R.sum(-1) - R.sum(-2)           # (B,H,nc,Q)
    gww = (u * Bg).sum(-1) * w[..., 0]                # gw_j w_j
    g = g - gww
    g[..., -1] += gww.sum(-1)
    gdA = g.flip(-1).cumsum(-1).flip(-1)
    gdt = gdA[..., None] * A[None, :, None, None, None] \
        + (gu * x).sum(-1, keepdim=True)
    gx = gu * dt
    gA = (gdA[..., None] * dt).sum((0, 2, 3, 4))
    return (gx, gdt, gA, _sum_heads_into_groups(gB, G),
            _sum_heads_into_groups(gC, G))
