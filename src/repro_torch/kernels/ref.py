"""Plain PyTorch oracles, one per function of ``repro/kernels/ref.py``.

Each is the semantic ground truth of its JAX twin, written the same
way (dense fp32 scores, full-row softmax), so a test can hold a kernel's
plain version, the JAX oracle and the Pallas kernel in interpret mode
against the same inputs.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qq = q.reshape(B, S, K, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qq * (D ** -0.5), k.float())
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    m = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        m &= qpos >= kpos
    if window and window > 0:
        m &= (qpos - kpos) < window
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def decode_attention_ref(q, k, v, *, cache_len, window: int = 0
                         ) -> torch.Tensor:
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qq = q.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qq * (D ** -0.5), k.float())
    kpos = torch.arange(S, device=q.device)[None, :]
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    m = kpos < cl
    if window and window > 0:
        m &= (cl - 1 - kpos) < window
    s = torch.where(m[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def decode_append_ref(cache, new, pos) -> torch.Tensor:
    """``cache[b, pos[b]] = new[b, 0]`` as a one-hot blend (out of place)."""
    B, S = cache.shape[:2]
    pos = torch.as_tensor(pos, dtype=torch.long,
                          device=cache.device).reshape(-1).expand(B)
    hot = torch.nn.functional.one_hot(pos, S).float()[..., None, None]
    out = cache.float() * (1.0 - hot) + new.float() * hot
    return out.to(cache.dtype)


def paged_gather_ref(pool, tbl) -> torch.Tensor:
    """Dense view of a paged cache; unassigned (-1) blocks read as zeros."""
    N, bl = pool.shape[:2]
    tbl = tbl.long()
    g = pool[tbl.clamp(0, N - 1)]                        # (B, nb, bl, K, D)
    g = torch.where((tbl >= 0)[..., None, None, None], g, 0)
    return g.reshape(tbl.shape[0], tbl.shape[1] * bl, *pool.shape[2:])


def paged_append_ref(pool, new, pos, tbl) -> torch.Tensor:
    """``pool[tbl[b, pos[b]//bl], pos[b]%bl] = new[b, 0]`` (out of place);
    a slot whose owning block is unassigned (-1) writes nothing."""
    B = new.shape[0]
    N, bl = pool.shape[:2]
    pos = torch.as_tensor(pos, dtype=torch.long,
                          device=pool.device).reshape(-1).expand(B)
    out = pool.float().clone()
    for b in range(B):
        blk = int(tbl[b, int(pos[b]) // bl])
        if blk >= 0:
            out[blk, int(pos[b]) % bl] = new[b, 0].float()
    return out.to(pool.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, tbl, *, cache_len,
                               window: int = 0) -> torch.Tensor:
    """Paged decode == dense decode over the gathered view."""
    return decode_attention_ref(q, paged_gather_ref(k_pool, tbl),
                                paged_gather_ref(v_pool, tbl),
                                cache_len=cache_len, window=window)


def ssd_scan_ref(x, dt, A, Bm, Cm, initial_state=None):
    """Sequential recurrence oracle, ``S_t = exp(dt_t A) S_{t-1} + dt_t
    B_t x_t``, ``y_t = S_t C_t``; groups pre-broadcast (Bm/Cm ``(B, S,
    H, N)``).  Returns ``(y (B, S, H, P), final_state (B, H, P, N))``."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    s = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state)
    ys = []
    for t in range(S):
        dec = torch.exp(dt[:, t] * A)[..., None, None]
        s = s * dec + torch.einsum("bh,bhn,bhp->bhpn", dt[:, t], Bm[:, t],
                                   x[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", s, Cm[:, t]))
    return torch.stack(ys, 1), s


def tiled_matmul_ref(a, b) -> torch.Tensor:
    """The product in fp32, cast back to ``a``'s dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)
