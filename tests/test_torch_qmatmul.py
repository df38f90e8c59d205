"""K1 (decode matvec) and K3 (prefill GEMM): the port's plain versions
against zllm's Pallas kernels run with interpret=True on a repacked,
npack Q4_K weight (K = N = 512), in f32.

Tolerance nmse < 1e-8 for both: the K1 group dots are integers below 2^24
and come out exact on both sides, so only the f32 sum order differs (plus
an ulp of rsqrt in the "norm" prologue); K3 rounds x and w to bf16 on both
sides, so again only the sum order differs."""

import numpy as np
import pytest
import torch
from test_torch_oracle import nmse, q4k_qtensor, qtensor_numpy, to_np

from zllm_torch.models.loader import params_from_jax
from zllm_torch.ops import qmatmul as tq

K = N = 512
RNG = np.random.default_rng(31)


@pytest.fixture(scope="module")
def weights():
    qt, _ = q4k_qtensor(N, K, seed=7, npack=True)
    w = params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")["output"]
    return qt, w


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_k1_plain_matches_pallas(weights, fuse, seed):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qt, w = weights
    rng = np.random.default_rng(seed)
    eps = 1e-5
    if fuse == "glu":
        x = rng.standard_normal((1, 2 * K)).astype(np.float32)
        want = qmm.qmatvec_glu(jnp.asarray(x), qt, interpret=True)
        got = tq.q4k_matvec(torch.from_numpy(x), w, fuse="glu")
    elif fuse == "norm":
        x = (rng.standard_normal((1, K)) * 3.0).astype(np.float32)
        wn = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        want = qmm.qmatvec_norm(jnp.asarray(x), jnp.asarray(wn), eps, qt, interpret=True)
        got = tq.q4k_matvec(torch.from_numpy(x), w, fuse="norm", aux=torch.from_numpy(wn),
                            eps=eps)
    else:
        x = rng.standard_normal((1, K)).astype(np.float32)
        want = qmm.qmatmul_w4a8(jnp.asarray(x), qt, interpret=True)
        got = tq.q4k_matvec(torch.from_numpy(x), w)
    assert tuple(got.shape) == (1, N) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) < 1e-8


def test_k1_bf16_activations(weights):
    """bf16 activations are read exactly (the prologue works in f32)."""
    qt, w = weights
    x = torch.from_numpy(RNG.standard_normal((1, K)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(tq.q4k_matvec(x, w), tq.q4k_matvec(x.float(), w))


@pytest.mark.parametrize("m", [2, 8])
def test_k3_plain_matches_pallas(weights, m):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qt, w = weights
    x = RNG.standard_normal((m, K)).astype(np.float32)
    want = qmm.qmatmul(jnp.asarray(x), qt, interpret=True)
    got = tq.q4k_gemm(torch.from_numpy(x), w)
    assert tuple(got.shape) == (m, N) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) < 1e-8


def test_cpu_wrappers_take_the_plain_path(weights):
    """On CPU tensors no kernel launches; other devices raise."""
    _, w = weights
    before = (tq.q4k_matvec.launches, tq.q4k_gemm.launches)
    x = torch.from_numpy(RNG.standard_normal((1, K)).astype(np.float32))
    assert torch.equal(tq.q4k_matvec(x, w), tq.q4k_matvec_plain(x, w))
    assert torch.equal(tq.q4k_gemm(x.repeat(3, 1), w), tq.q4k_gemm_plain(x.repeat(3, 1), w))
    assert (tq.q4k_matvec.launches, tq.q4k_gemm.launches) == before
    with pytest.raises(ValueError):
        tq.q4k_matvec(x.to("meta"), w)
    with pytest.raises(ValueError):
        tq.q4k_matvec(torch.zeros(1, K + 1), w)
