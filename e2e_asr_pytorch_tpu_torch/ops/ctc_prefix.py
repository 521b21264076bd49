"""Batched CTC prefix scoring for joint beam decoding (port of
e2e_asr_pytorch_tpu/ops/ctc_prefix.py).

Watanabe et al.'s prefix score, restricted to the candidates a beam step
proposes, with a batch axis (B utterances) and a beam axis (K hypotheses):

  * the prefix score psi_t = logaddexp(psi_{t-1}, phi[t-1] + x[t]) is an
    order-independent accumulation, a masked log-sum-exp over time:
    ``score_psi`` has no recursion;
  * the forward variables r[t] = (r_nb, r_b) are a 2-state linear recurrence
    in the (logaddexp, +) semiring, advanced only for the one token each
    beam takes. ``advance_state`` composes the per-frame 2x2 affine maps
    with a log-depth (Hillis-Steele) doubling scan, ceil(log2 T) rounds of
    whole-tensor ops, where the JAX package runs ``lax.associative_scan``.

``advance_state_loop`` is the per-frame recursion itself, a Python loop over
T, kept as an independent reference for the tests; no decode path calls it.

Padding: frames >= enc_len (and frames before the prefix can have ended)
compose the identity map, so the recursion freezes there.
"""

from __future__ import annotations

from typing import Tuple

import torch

LOG_ZERO = -1e8


def init_state(ctc_logp: torch.Tensor, enc_len: torch.Tensor) -> torch.Tensor:
    """Initial r for the empty prefix: blanks accumulated over time.

    ctc_logp: (B,T,V) log-softmax CTC posteriors. Returns r0 (B,T,2)."""
    b, t, _ = ctc_logp.shape
    blank = ctc_logp[:, :, 0]
    valid = (torch.arange(t, device=ctc_logp.device)[None, :]
             < enc_len[:, None])
    csum = torch.cumsum(torch.where(valid, blank, torch.zeros_like(blank)),
                        dim=1)
    return torch.stack([torch.full_like(csum, LOG_ZERO), csum], dim=-1)


def _phi(r_prev: torch.Tensor, same: torch.Tensor) -> torch.Tensor:
    """phi[t] = logaddexp(r_nb[t], r_b[t]), with the non-blank path closed
    when the candidate repeats the prefix's last token. r_prev (..., T, 2),
    same (...) bool. Returns (..., T)."""
    r_nb = torch.where(same[..., None],
                       torch.full_like(r_prev[..., 0], LOG_ZERO),
                       r_prev[..., 0])
    return torch.logaddexp(r_nb, r_prev[..., 1])


def _gather_frames(ctc_logp: torch.Tensor, tokens: torch.Tensor):
    """x[b,k,t,c] = ctc_logp[b,t,tokens[b,k,c]] for tokens (B,K,C)."""
    b, t, v = ctc_logp.shape
    k, c = tokens.shape[1:]
    return torch.gather(ctc_logp[:, None].expand(b, k, t, v), 3,
                        tokens[:, :, None, :].expand(b, k, t, c))


def score_psi(ctc_logp: torch.Tensor, enc_len: torch.Tensor,
              r_prev: torch.Tensor, last_tok: torch.Tensor,
              candidates: torch.Tensor, prefix_len: int) -> torch.Tensor:
    """Prefix scores psi (B,K,C) of candidate extensions, no recursion.

    psi = logaddexp(psi0, LSE_{t in [start, enc_len)} phi[t-1] + x[t]) with
    psi0 = x[0] for the empty prefix else log-zero; the <eos> candidate (id
    1) scores logaddexp(r_nb, r_b) at the last valid frame.

    ctc_logp (B,T,V), enc_len (B,), r_prev (B,K,T,2), last_tok (B,K),
    candidates (B,K,C), prefix_len: the current prefix length (every live
    hypothesis at decode step t has length t)."""
    t = ctc_logp.shape[1]
    dev = ctc_logp.device
    x = _gather_frames(ctc_logp, candidates).movedim(3, 2)         # B,K,C,T
    same = (candidates == last_tok[:, :, None]) & (prefix_len > 0)
    phi = _phi(r_prev[:, :, None], same)                           # B,K,C,T
    steps = torch.arange(1, t, device=dev)
    valid = ((steps[None, :] >= max(1, prefix_len))
             & (steps[None, :] < enc_len[:, None]))                # B,T-1
    contrib = torch.where(valid[:, None, None, :], phi[..., :-1] + x[..., 1:],
                          torch.full_like(x[..., 1:], LOG_ZERO))
    psi0 = (x[..., 0] if prefix_len == 0
            else torch.full_like(x[..., 0], LOG_ZERO))
    psi = torch.logaddexp(psi0, torch.logsumexp(contrib, dim=-1))
    # <eos>: the whole prefix's probability at the last valid frame
    last = torch.clamp(enc_len - 1, min=0)[:, None, None].expand(
        -1, r_prev.shape[1], 1)
    sum_last = torch.logaddexp(torch.gather(r_prev[..., 0], 2, last),
                               torch.gather(r_prev[..., 1], 2, last))
    return torch.where(candidates == 1, sum_last, psi)


def _log_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, m) x (..., m, p) product in the (logaddexp, +) semiring."""
    return torch.logsumexp(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def _compose(e1, e2):
    """The affine map e2 after e1 (each v -> A v (+) b)."""
    a1, b1 = e1
    a2, b2 = e2
    return (_log_matmul(a2, a1),
            torch.logaddexp(_log_matmul(a2, b1[..., None])[..., 0], b2))


def _prefix_maps(a: torch.Tensor, b: torch.Tensor):
    """Inclusive prefix compositions over axis 0 (time) by doubling: after
    the round of stride d, entry t holds the maps of frames (t-2d, t]
    composed, so ceil(log2 T) rounds cover every prefix."""
    d = 1
    while d < a.shape[0]:
        a_new, b_new = _compose((a[:-d], b[:-d]), (a[d:], b[d:]))
        a = torch.cat([a[:d], a_new])
        b = torch.cat([b[:d], b_new])
        d *= 2
    return a, b


def _maps(ctc_logp, enc_len, r_prev, last_tok, new_tok, prefix_len):
    """The per-frame pieces of the recursion for ``new_tok`` (B,K): x (B,K,T),
    blank (B,K,T), phi[t-1] (B,K,T), the update mask (B,1,T) and the state
    before frame 0, v_init (B,K,2)."""
    b, t, _ = ctc_logp.shape
    k = r_prev.shape[1]
    dev = ctc_logp.device
    x = _gather_frames(ctc_logp, new_tok[:, :, None])[..., 0]     # B,K,T
    blank = ctc_logp[:, None, :, 0].expand(b, k, t)
    same = (new_tok == last_tok) & (prefix_len > 0)
    phi = _phi(r_prev, same)
    phi_prev = torch.cat([torch.full_like(phi[..., :1], LOG_ZERO),
                          phi[..., :-1]], dim=-1)
    steps = torch.arange(t, device=dev)
    upd = ((steps[None, :] >= max(1, prefix_len))
           & (steps[None, :] < enc_len[:, None]))[:, None, :]      # B,1,T
    r0_nb = (x[..., 0] if prefix_len == 0
             else torch.full_like(x[..., 0], LOG_ZERO))
    v_init = torch.stack([r0_nb, torch.full_like(r0_nb, LOG_ZERO)], dim=-1)
    return x, blank, phi_prev, upd, v_init


def advance_state(ctc_logp: torch.Tensor, enc_len: torch.Tensor,
                  r_prev: torch.Tensor, last_tok: torch.Tensor,
                  new_tok: torch.Tensor, prefix_len: int) -> torch.Tensor:
    """Advance r by one token per beam: r_new (B,K,T,2) for ``new_tok``.

    The per-frame recursion
        r_nb[t] = logaddexp(r_nb[t-1], phi[t-1]) + x[t]
        r_b[t]  = logaddexp(r_b[t-1],  r_nb[t-1]) + blank[t]
    is affine in the (logaddexp, +) semiring: frame t is the map
    A[t] = [[x, LZ], [blank, blank]], b[t] = [phi[t-1] + x, LZ], and the T
    axis runs as a log-depth scan of those maps, no loop over frames.
    Frozen frames (t < max(1, prefix_len) or t >= enc_len) compose the
    identity map."""
    x, blank, phi_prev, upd, v_init = _maps(ctc_logp, enc_len, r_prev,
                                            last_tok, new_tok, prefix_len)
    lz = torch.full_like(x, LOG_ZERO)
    zero = torch.zeros_like(x)
    a = torch.stack([torch.stack([x, lz], -1),
                     torch.stack([blank, blank], -1)], -2)         # B,K,T,2,2
    bb = torch.stack([phi_prev + x, lz], -1)                       # B,K,T,2
    ident = torch.stack([torch.stack([zero, lz], -1),
                         torch.stack([lz, zero], -1)], -2)
    a = torch.where(upd[..., None, None], a, ident)
    bb = torch.where(upd[..., None], bb, torch.full_like(bb, LOG_ZERO))
    a_pref, b_pref = _prefix_maps(a.movedim(2, 0), bb.movedim(2, 0))
    r_new = torch.logaddexp(
        _log_matmul(a_pref, v_init[None, ..., None])[..., 0], b_pref)
    return r_new.movedim(0, 2)


def advance_state_loop(ctc_logp: torch.Tensor, enc_len: torch.Tensor,
                       r_prev: torch.Tensor, last_tok: torch.Tensor,
                       new_tok: torch.Tensor, prefix_len: int
                       ) -> torch.Tensor:
    """``advance_state`` as the per-frame recursion of its docstring, one
    Python step a frame: the tests' second reference, independent of both
    scans."""
    x, blank, phi_prev, upd, r = _maps(ctc_logp, enc_len, r_prev, last_tok,
                                       new_tok, prefix_len)
    out = []
    for t in range(x.shape[-1]):
        new = torch.stack(
            [torch.logaddexp(r[..., 0], phi_prev[..., t]) + x[..., t],
             torch.logaddexp(r[..., 1], r[..., 0]) + blank[..., t]], dim=-1)
        r = torch.where(upd[..., t, None], new, r)
        out.append(r)
    return torch.stack(out, dim=2)


def score_candidates(ctc_logp: torch.Tensor, enc_len: torch.Tensor,
                     r_prev: torch.Tensor, psi_prev: torch.Tensor,
                     last_tok: torch.Tensor, candidates: torch.Tensor,
                     prefix_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score candidate extensions and materialize their forward variables:
    (psi (B,K,C), r_new (B,K,C,T,2)). The beam decoder itself advances only
    the selected token; this is the compatibility surface."""
    del psi_prev  # kept for interface symmetry with the JAX package
    psi = score_psi(ctc_logp, enc_len, r_prev, last_tok, candidates,
                    prefix_len)
    adv = torch.stack([advance_state(ctc_logp, enc_len, r_prev, last_tok,
                                     candidates[:, :, c], prefix_len)
                       for c in range(candidates.shape[-1])], dim=2)
    return psi, adv
