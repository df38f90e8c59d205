"""The port's batched sampler chain against zllm's (sampling/batched.py).

Both take the same numpy logits, recent-token windows, DRY breaker table,
mirostat state and per-slot parameters.  The draws cannot match (JAX's
PRNG against one torch.Generator per slot), so parity is held on what does
not depend on them: the post-chain logits (atol = rtol = 1e-5, and the
same positions masked to NEG_INF), the greedy tokens, and mirostat's mu
update for a given drawn token.  XTC draws a coin, so it is held at
probability 0 (never applies) and 1 (always applies)."""

import numpy as np
import pytest
import torch

B, V, W = 4, 128, 64

CASES = {
    "greedy": dict(temp=0.0),
    "penalties": dict(repeat_penalty=1.3, freq_penalty=0.2, presence_penalty=0.1),
    "dry": dict(dry_multiplier=0.8, dry_base=1.75, dry_allowed_length=2),
    "top_k": dict(top_k=5, top_p=1.0, min_p=0.0),
    "typical": dict(typical_p=0.7, top_k=0, min_p=0.0),
    "top_p": dict(top_p=0.8, top_k=0, min_p=0.0),
    "min_p": dict(min_p=0.1, top_k=0, top_p=1.0),
    "top_n_sigma": dict(top_n_sigma=1.5, top_k=0, top_p=1.0, min_p=0.0),
    "xtc0": dict(xtc_probability=0.0, xtc_threshold=0.02, top_k=0, min_p=0.0),
    "xtc1": dict(xtc_probability=1.0, xtc_threshold=0.02, top_k=0, min_p=0.0),
    "dynatemp": dict(dynatemp_range=0.5, dynatemp_exponent=1.5),
    "mirostat": dict(mirostat=2, mirostat_tau=3.0, top_k=0, top_p=1.0, min_p=0.0),
    "mixed_rows": None,  # one row each of greedy, top-k, mirostat, xtc1
}


def _inputs(case):
    from zllm.sampling.batched import SlotParams

    r = np.random.default_rng(sorted(CASES).index(case))
    logits = (r.standard_normal((B, V)) * 3).astype(np.float32)
    recent = np.full((B, W), -1, np.int32)
    for b in range(B):  # a repeating tail (DRY matches) over a partly empty window
        pat = r.integers(0, V, size=5)
        seq = np.concatenate([r.integers(0, V, size=20), pat, r.integers(0, V, size=7), pat[:3]])
        recent[b, -len(seq):] = seq
    br_mask = r.random(V) < 0.05
    p = SlotParams(B)
    if CASES[case] is None:
        rows = [CASES["greedy"], CASES["top_k"], CASES["mirostat"], CASES["xtc1"]]
    else:
        rows = [CASES[case]] * B
    for b, kw in enumerate(rows):
        for k, v in kw.items():
            getattr(p, k)[b] = v
    mu = (2.0 * p.mirostat_tau).astype(np.float32)
    return logits, recent, br_mask, mu, p.arrays()


def _zllm(logits, recent, br_mask, mu, arrays, seed=0):
    import jax.numpy as jnp

    from zllm.sampling.batched import make_keys, sample_batch

    toks, lg, _, new_mu = sample_batch(
        jnp.asarray(logits), make_keys(range(seed, seed + B)), jnp.asarray(recent),
        jnp.asarray(br_mask), jnp.asarray(mu), *[jnp.asarray(a) for a in arrays])
    return np.array(toks), np.array(lg), np.array(new_mu)


def _port(logits, recent, br_mask, mu, arrays, seed=0):
    from zllm_torch.sampling.batched import sample_batch

    gens = [torch.Generator().manual_seed(seed + i) for i in range(B)]
    toks, lg, new_mu = sample_batch(
        torch.from_numpy(logits), gens, torch.from_numpy(recent), torch.from_numpy(br_mask),
        torch.from_numpy(mu), *[torch.from_numpy(a) for a in arrays])
    return toks.numpy(), lg.numpy(), new_mu.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_post_chain_logits_match_zllm(case):
    from zllm_torch.sampling.batched import NEG_INF

    inputs = _inputs(case)
    ztoks, zlg, _ = _zllm(*inputs)
    ttoks, tlg, _ = _port(*inputs)
    zmask, tmask = zlg <= NEG_INF / 2, tlg <= NEG_INF / 2
    np.testing.assert_array_equal(tmask, zmask)
    np.testing.assert_allclose(tlg[~zmask], zlg[~zmask], rtol=1e-5, atol=1e-5)
    assert (~tmask).sum(axis=1).min() >= 1
    # every draw is a token the chain kept
    assert not tmask[np.arange(B), ttoks].any()
    temp = inputs[4][0]
    greedy = temp <= 0
    np.testing.assert_array_equal(ttoks[greedy], ztoks[greedy])


def test_filters_do_something():
    """The cases are not vacuous: each truncating filter masks tokens, and
    XTC at probability 1 masks what it leaves at probability 0."""
    from zllm_torch.sampling.batched import NEG_INF

    for case in ("top_k", "typical", "top_p", "min_p", "top_n_sigma", "mirostat", "xtc1"):
        masked = (_port(*_inputs(case))[1] <= NEG_INF / 2).sum(axis=1)
        assert (masked > 0).all(), case
    *rest, arrays = _inputs("xtc1")
    off = list(arrays)
    off[6] = np.zeros_like(arrays[6])  # xtc_probability 0 on the same inputs
    on_masked = (_port(*rest, arrays)[1] <= NEG_INF / 2).sum(axis=1)
    off_masked = (_port(*rest, tuple(off))[1] <= NEG_INF / 2).sum(axis=1)
    assert (on_masked > off_masked).all()


def test_mirostat_mu_update_for_a_fixed_token():
    """zllm's new mu from its own draw equals the port's update of the same
    token on zllm's post-chain logits."""
    from zllm_torch.sampling.batched import mirostat_mu

    logits, recent, br_mask, mu, arrays = _inputs("mirostat")
    ztoks, zlg, zmu = _zllm(logits, recent, br_mask, mu, arrays)
    p = dict(zip(("mirostat", "mirostat_tau", "mirostat_eta"), arrays[16:19]))
    got = mirostat_mu(torch.from_numpy(zlg), torch.from_numpy(ztoks), torch.from_numpy(mu),
                      torch.from_numpy(p["mirostat"]), torch.from_numpy(p["mirostat_tau"]),
                      torch.from_numpy(p["mirostat_eta"]))
    np.testing.assert_allclose(got.numpy(), zmu, rtol=1e-5, atol=1e-5)
    assert not np.allclose(zmu, mu)  # the servo moved


def test_draws_follow_each_slot_seed():
    """A slot's draws depend on its own generator only: the same seeds give
    the same tokens, and reseeding one slot leaves the others' draws."""
    inputs = _inputs("top_p")
    a, _, _ = _port(*inputs, seed=3)
    b, _, _ = _port(*inputs, seed=3)
    np.testing.assert_array_equal(a, b)
    many = [_port(*inputs, seed=s)[0] for s in range(8)]
    assert len({tuple(m) for m in many}) > 1


def test_slot_params_and_breaker_mask_match_zllm():
    from zllm.sampling.batched import SlotParams as ZSlotParams
    from zllm.sampling.batched import breaker_mask as zbreaker
    from zllm.server.engine import Request as ZRequest
    from zllm.tokenizer import Tokenizer as ZTokenizer
    from zllm.tokenizer.vocab import Vocab as ZVocab
    from zllm_torch.sampling.batched import SlotParams, breaker_mask
    from zllm_torch.server.engine import Request
    from zllm_torch.tokenizer import Tokenizer
    from zllm_torch.tokenizer.vocab import Vocab as TVocab

    kw = dict(temp=0.5, top_k=7, top_p=0.9, min_p=0.02, typical_p=0.8, top_n_sigma=1.0,
              xtc_probability=0.3, xtc_threshold=0.2, repeat_penalty=1.1, freq_penalty=0.1,
              presence_penalty=0.2, dry_multiplier=0.5, dry_base=2.0, dry_allowed_length=3,
              dynatemp_range=0.2, dynatemp_exponent=1.2, mirostat=0, mirostat_tau=4.0,
              mirostat_eta=0.2)
    zp, tp = ZSlotParams(3), SlotParams(3)
    zp.set_slot(1, ZRequest(prompt_tokens=[1], **kw))
    tp.set_slot(1, Request(prompt_tokens=[1], **kw))
    zp.set_slot(2, ZRequest(prompt_tokens=[1], **dict(kw, mirostat=2)))
    tp.set_slot(2, Request(prompt_tokens=[1], **dict(kw, mirostat=2)))
    for a, b in zip(tp.arrays(), zp.arrays()):
        np.testing.assert_array_equal(a, b)

    tokens = ["<unk>", "<s>", "</s>", "a", "b:", "\n", "x*y", 'q"', "plain", "::"]
    kw = dict(model="llama", pre="default", tokens=tokens, scores=[0.0] * len(tokens),
              types=[2, 3, 3] + [1] * (len(tokens) - 3), bos_id=1, eos_id=2, unk_id=0)
    tt = Tokenizer(TVocab(**kw))
    zt = ZTokenizer(ZVocab(**kw))
    want = np.zeros(12, bool)
    want[[4, 5, 6, 7, 9]] = True
    np.testing.assert_array_equal(zbreaker(zt, 12), want)
    np.testing.assert_array_equal(breaker_mask(tt, 12), want)
    assert not breaker_mask(None, 12).any()
