"""Batched sampler chain for the serving engine (counterpart of
`zllm/sampling/batched.py`).

One call samples every slot's next token with per-slot parameters
(struct-of-arrays), on the logits' device.  The chain order and semantics
are zllm's: penalties -> DRY -> top-k -> typical -> top-p -> min-p ->
top-n-sigma -> XTC -> temperature (dynamic temperature; temp <= 0 is
greedy) -> mirostat v2 -> categorical.  Each slot draws from its own
`torch.Generator` (seeded from the request's seed), so a request's draws do
not depend on the other slots.  JAX's PRNG stream is not reproduced: the
same seed gives other draws than zllm, while the post-chain logits and the
greedy tokens are the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


@dataclass
class SlotParams:
    """Host-side per-slot sampling parameters (numpy struct-of-arrays)."""

    n: int
    temp: np.ndarray = field(default=None)
    top_k: np.ndarray = field(default=None)
    top_p: np.ndarray = field(default=None)
    min_p: np.ndarray = field(default=None)
    typical_p: np.ndarray = field(default=None)
    top_n_sigma: np.ndarray = field(default=None)
    xtc_probability: np.ndarray = field(default=None)
    xtc_threshold: np.ndarray = field(default=None)
    repeat_penalty: np.ndarray = field(default=None)
    freq_penalty: np.ndarray = field(default=None)
    presence_penalty: np.ndarray = field(default=None)
    dry_multiplier: np.ndarray = field(default=None)
    dry_base: np.ndarray = field(default=None)
    dry_allowed_length: np.ndarray = field(default=None)
    dynatemp_range: np.ndarray = field(default=None)
    dynatemp_exponent: np.ndarray = field(default=None)
    mirostat: np.ndarray = field(default=None)
    mirostat_tau: np.ndarray = field(default=None)
    mirostat_eta: np.ndarray = field(default=None)

    def __post_init__(self):
        n = self.n
        defaults = dict(
            temp=0.8, top_k=40, top_p=0.95, min_p=0.05, typical_p=1.0,
            top_n_sigma=0.0, xtc_probability=0.0, xtc_threshold=0.1,
            repeat_penalty=1.0, freq_penalty=0.0, presence_penalty=0.0,
            dry_multiplier=0.0, dry_base=1.75, dry_allowed_length=2.0,
            dynatemp_range=0.0, dynatemp_exponent=1.0,
            mirostat=0.0, mirostat_tau=5.0, mirostat_eta=0.1,
        )
        for k, v in defaults.items():
            if getattr(self, k) is None:
                setattr(self, k, np.full((n,), v, np.float32))

    def set_slot(self, i: int, req) -> None:
        """Copy one request's sampling params into row i."""
        self.temp[i] = req.temp
        self.top_k[i] = req.top_k
        self.top_p[i] = req.top_p
        self.min_p[i] = req.min_p
        self.typical_p[i] = req.typical_p
        self.top_n_sigma[i] = req.top_n_sigma
        self.xtc_probability[i] = req.xtc_probability
        self.xtc_threshold[i] = req.xtc_threshold
        self.repeat_penalty[i] = req.repeat_penalty
        self.freq_penalty[i] = req.freq_penalty
        self.presence_penalty[i] = req.presence_penalty
        self.dry_multiplier[i] = req.dry_multiplier
        self.dry_base[i] = req.dry_base
        self.dry_allowed_length[i] = req.dry_allowed_length
        self.dynatemp_range[i] = req.dynatemp_range
        self.dynatemp_exponent[i] = req.dynatemp_exponent
        self.mirostat[i] = req.mirostat
        self.mirostat_tau[i] = req.mirostat_tau
        self.mirostat_eta[i] = req.mirostat_eta
        if self.mirostat[i] > 0:
            # mirostat replaces the truncation stack (the chain is
            # penalties -> temp -> mirostat; top-k/p/etc. are not applied)
            self.top_k[i] = 0
            self.top_p[i] = 1.0
            self.min_p[i] = 0.0
            self.typical_p[i] = 1.0
            self.top_n_sigma[i] = 0.0
            self.xtc_probability[i] = 0.0

    def arrays(self) -> tuple:
        return (
            self.temp, self.top_k, self.top_p, self.min_p, self.typical_p,
            self.top_n_sigma, self.xtc_probability, self.xtc_threshold,
            self.repeat_penalty, self.freq_penalty, self.presence_penalty,
            self.dry_multiplier, self.dry_base, self.dry_allowed_length,
            self.dynatemp_range, self.dynatemp_exponent,
            self.mirostat, self.mirostat_tau, self.mirostat_eta,
        )


def _penalties_b(lg, recent, repeat, freq, presence):
    """recent: int [B, W], -1 = empty."""
    valid = recent >= 0
    idx = torch.where(valid, recent, torch.zeros_like(recent)).long()
    counts = torch.zeros_like(lg).scatter_add_(1, idx, valid.float())
    present = counts > 0
    rp = repeat[:, None]
    pen = torch.where(lg > 0, lg / rp, lg * rp)
    out = torch.where(present & (rp != 1.0), pen, lg)
    return out - counts * freq[:, None] - present.float() * presence[:, None]


def _top_k_b(lg, k):
    vocab = lg.shape[-1]
    srt = torch.sort(lg, dim=-1, descending=True).values
    kidx = torch.clamp(k.long() - 1, 0, vocab - 1)
    kth = torch.gather(srt, 1, kidx[:, None])
    return torch.where((k[:, None] > 0) & (lg < kth), NEG_INF, lg)


def _top_p_b(lg, p):
    srt = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < p[:, None]
    n_keep = torch.clamp(keep.sum(dim=-1), min=1)
    cutoff = torch.gather(srt, 1, (n_keep - 1)[:, None])
    return torch.where((p[:, None] < 1.0) & (lg < cutoff), NEG_INF, lg)


def _min_p_b(lg, p):
    mx = lg.amax(dim=-1, keepdim=True)
    thr = mx + torch.log(torch.clamp(p[:, None], min=1e-10))
    return torch.where((p[:, None] > 0) & (lg < thr), NEG_INF, lg)


def _typical_b(lg, p):
    probs = torch.softmax(lg, dim=-1)
    logp = torch.log(probs + 1e-30)
    ent = -(probs * logp).sum(dim=-1, keepdim=True)
    shifted = torch.abs(-logp - ent)
    order = torch.argsort(shifted, dim=-1, stable=True)
    sp = torch.gather(probs, 1, order)
    cum = torch.cumsum(sp, dim=-1)
    keep_sorted = cum - sp < p[:, None]
    n_keep = torch.clamp(keep_sorted.sum(dim=-1), min=1)
    rank = torch.argsort(order, dim=-1, stable=True)
    masked = torch.where(rank < n_keep[:, None], lg, NEG_INF)
    return torch.where(p[:, None] < 1.0, masked, lg)


def _top_n_sigma_b(lg, n):
    valid = lg > NEG_INF / 2
    cnt = valid.sum(dim=-1, keepdim=True)
    mean = torch.where(valid, lg, 0.0).sum(dim=-1, keepdim=True) / cnt
    var = torch.where(valid, (lg - mean) ** 2, 0.0).sum(dim=-1, keepdim=True) / cnt
    mx = lg.amax(dim=-1, keepdim=True)
    thr = mx - n[:, None] * torch.sqrt(var)
    return torch.where((n[:, None] > 0) & (lg < thr), NEG_INF, lg)


def _xtc_b(lg, prob, thr, coin):
    """coin [B]: one uniform draw per row from the row's generator."""
    probs = torch.softmax(lg, dim=-1)
    above = probs > thr[:, None]
    n_above = above.sum(dim=-1, keepdim=True)
    least = torch.where(above, probs, torch.inf).amin(dim=-1, keepdim=True)
    cut = above & (probs > least)
    masked = torch.where(cut, NEG_INF, lg)
    apply = (coin[:, None] < prob[:, None]) & (n_above >= 2)
    return torch.where(apply, masked, lg)


def _dry_b(lg, recent, mult, base, allowed, br_mask):
    """DRY repetition penalty: a candidate token z that would extend an
    earlier occurrence of the current context suffix is penalized
    mult * base^(n - allowed), n the matched suffix length (capped at 48).
    O(W^2) suffix match over the recent window; `br_mask` is a [V] bool
    sequence-breaker table (tokens whose text holds a breaker end matches)."""
    b, w = recent.shape
    dev = lg.device
    valid = recent >= 0
    z = torch.where(valid, recent, torch.zeros_like(recent)).long()
    is_br = br_mask[z] & valid  # [B, W]

    t_idx = torch.arange(w, device=dev)
    jm = torch.arange(w, device=dev)[:, None] - 1 - t_idx[None, :]  # [W(j), W(t)]
    wm = w - 1 - t_idx  # [W(t)]
    ok = jm >= 0
    jc = torch.clamp(jm, 0, w - 1)
    a = recent[:, jc]  # [B, W, W]
    c = recent[:, wm]  # [B, W]
    abr = is_br[:, jc]
    cbr = is_br[:, wm]
    eq = (ok[None] & (a == c[:, None, :]) & (a >= 0) & (c[:, None, :] >= 0)
          & ~abr & ~cbr[:, None, :])
    run = torch.cumprod(eq.int(), dim=-1)
    n_match = run.sum(dim=-1).float()  # [B, W]

    ncap = torch.clamp(n_match, max=48.0)
    pen_j = mult[:, None] * torch.pow(torch.clamp(base[:, None], min=1.0),
                                      ncap - allowed[:, None])
    pen_j = torch.where((n_match >= allowed[:, None]) & valid & ~is_br & (mult[:, None] > 0),
                        pen_j, 0.0)
    pen = torch.zeros_like(lg).scatter_reduce_(1, z, pen_j, reduce="amax", include_self=True)
    return lg - pen


def _temperature_b(lg, temp, dt_range, dt_expo):
    # dynamic temperature: scale temp within [temp-range, temp+range] by the
    # normalized candidate entropy
    valid = lg > NEG_INF / 2
    probs = torch.softmax(torch.where(valid, lg, NEG_INF), dim=-1)
    ent = -torch.where(probs > 0, probs * torch.log(probs + 1e-30), 0.0).sum(dim=-1)
    max_ent = torch.log(torch.clamp(valid.sum(dim=-1).float(), min=2.0))
    norm = torch.clamp(ent / max_ent, 0.0, 1.0) ** torch.clamp(dt_expo, min=1e-3)
    lo = torch.clamp(temp - dt_range, min=0.0)
    hi = temp + dt_range
    t_eff = torch.where(dt_range > 0, lo + (hi - lo) * norm, temp)

    # temp <= 0 is greedy: a one-hot on the FIRST argmax, so the draw does
    # not depend on the generator
    amax = torch.argmax(lg, dim=-1)
    iota = torch.arange(lg.shape[-1], device=lg.device)[None, :]
    greedy = torch.where(iota == amax[:, None], 0.0, NEG_INF)
    return torch.where(t_eff[:, None] <= 0, greedy, lg / torch.clamp(t_eff[:, None], min=1e-6))


def mirostat_mu(lg, toks, mu, mirostat, tau, eta):
    """Mirostat v2's servo of mu toward the target surprise tau, after the
    token `toks` was drawn from the post-chain logits `lg`."""
    p_tok = torch.gather(torch.softmax(lg, dim=-1), 1, toks.long()[:, None])[:, 0]
    s_obs = -torch.log(torch.clamp(p_tok, min=1e-30)) * LOG2E
    return torch.where(mirostat > 0, mu - eta * (s_obs - tau), mu)


def _uniform(gens, n: int, device) -> torch.Tensor:
    """[len(gens), n] uniforms in [0, 1), row i from generator i."""
    return torch.stack([torch.rand(n, generator=g, device=device) for g in gens])


def sample_batch(logits: torch.Tensor, gens: list, recent: torch.Tensor, br_mask: torch.Tensor,
                 mu: torch.Tensor, temp, top_k, top_p, min_p, typical_p, top_n_sigma,
                 xtc_probability, xtc_threshold, repeat_penalty, freq_penalty,
                 presence_penalty, dry_multiplier, dry_base, dry_allowed_length,
                 dynatemp_range, dynatemp_exponent, mirostat, mirostat_tau, mirostat_eta):
    """logits [B, V]; gens one torch.Generator per row, on the logits'
    device (each advances by this call's draws); recent [B, W] int (-1
    empty); br_mask [V] bool; mu [B] f32 mirostat-v2 state; the per-slot
    parameters as [B] tensors.  Returns (tokens [B] int32, post-chain
    logits [B, V], new mu [B]).  Grammar-constrained rows arrive with the
    grammar mask already folded into `logits` (the engine's resample pass),
    so the full chain applies to them too."""
    lg = logits.float()
    lg = _penalties_b(lg, recent, repeat_penalty, freq_penalty, presence_penalty)
    lg = _dry_b(lg, recent, dry_multiplier, dry_base, dry_allowed_length, br_mask)
    lg = _top_k_b(lg, top_k)
    lg = _typical_b(lg, typical_p)
    lg = _top_p_b(lg, top_p)
    lg = _min_p_b(lg, min_p)
    lg = _top_n_sigma_b(lg, top_n_sigma)
    coin = _uniform(gens, 1, lg.device)[:, 0]
    lg = _xtc_b(lg, xtc_probability, xtc_threshold, coin)
    lg = _temperature_b(lg, temp, dynatemp_range, dynatemp_exponent)

    # mirostat v2: drop candidates whose surprise -log2 p exceeds mu (always
    # keeping the argmax); mu is updated after the draw
    act = mirostat > 0
    probs = torch.softmax(lg, dim=-1)
    surprise = -torch.log(torch.clamp(probs, min=1e-30)) * LOG2E
    amax = torch.argmax(lg, dim=-1)
    iota = torch.arange(lg.shape[-1], device=lg.device)[None, :]
    keep = (surprise <= mu[:, None]) | (iota == amax[:, None])
    lg = torch.where(act[:, None] & ~keep, NEG_INF, lg)

    # categorical draw by the Gumbel-max trick, one row per generator
    u = _uniform(gens, lg.shape[-1], lg.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    toks = torch.argmax(lg + gumbel, dim=-1).to(torch.int32)
    return toks, lg, mirostat_mu(lg, toks, mu, mirostat, mirostat_tau, mirostat_eta)


def breaker_mask(tokenizer, vocab_size: int, breakers=("\n", ":", "\"", "*")) -> np.ndarray:
    """[V] bool: tokens whose piece contains a DRY sequence breaker."""
    mask = np.zeros((vocab_size,), bool)
    if tokenizer is None:
        return mask
    for i, piece in enumerate(tokenizer.vocab.tokens[:vocab_size]):
        if any(b in piece for b in breakers):
            mask[i] = True
    return mask
