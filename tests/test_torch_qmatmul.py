"""K1/K4 (decode matvecs) and K3/K5 (prefill GEMMs): the port's plain
versions against zllm's Pallas kernels run with interpret=True, K1/K3 on a
repacked, npack Q4_K weight (K = N = 512), K4/K5 on repacked Q6_K and Q8_0
weights (K = 512, N = 256), in f32.

Tolerance nmse < 1e-8 for all four: the K1/K4 group dots are integers
below 2^24 and come out exact on both sides, so only the f32 sum order
differs (plus an ulp of rsqrt in the "norm" prologue); K3/K5 round x and w
to bf16 on both sides, so again only the sum order differs."""

import numpy as np
import pytest
import torch
from test_torch_oracle import nmse, q4k_qtensor, qtensor_numpy, quant_qtensor, to_np

from zllm.gguf.constants import GGMLType

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


INT_FMTS = [GGMLType.Q6_K, GGMLType.Q8_0]
N4 = 256


@pytest.fixture(scope="module", params=INT_FMTS, ids=lambda t: t.name)
def int_weights(request):
    qt, _ = quant_qtensor(request.param, N4, K, seed=11)
    w = params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")["output"]
    return qt, w


@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_k4_plain_matches_pallas(int_weights, fuse):
    """Q6_K quantizes the activations in 16-groups, Q8_0 in 32-groups, as
    zllm's _INT_FMT has them."""
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qt, w = int_weights
    rng = np.random.default_rng(5)
    eps = 1e-5
    if fuse == "glu":
        x = rng.standard_normal((1, 2 * K)).astype(np.float32)
        want = qmm.qmatvec_glu(jnp.asarray(x), qt, interpret=True)
        got = tq.int8_matvec(torch.from_numpy(x), w, fuse="glu")
    elif fuse == "norm":
        x = (rng.standard_normal((1, K)) * 3.0).astype(np.float32)
        wn = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        want = qmm.qmatvec_norm(jnp.asarray(x), jnp.asarray(wn), eps, qt, interpret=True)
        got = tq.int8_matvec(torch.from_numpy(x), w, fuse="norm", aux=torch.from_numpy(wn),
                             eps=eps)
    else:
        x = rng.standard_normal((1, K)).astype(np.float32)
        want = qmm.qmatmul_w4a8(jnp.asarray(x), qt, interpret=True)
        got = tq.int8_matvec(torch.from_numpy(x), w)
    assert tuple(got.shape) == (1, N4) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) < 1e-8


@pytest.mark.parametrize("m", [2, 8])
def test_k5_plain_matches_pallas(int_weights, m):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qt, w = int_weights
    x = RNG.standard_normal((m, K)).astype(np.float32)
    want = qmm.qmatmul(jnp.asarray(x), qt, interpret=True)
    got = tq.dequant_gemm(torch.from_numpy(x), w)
    assert tuple(got.shape) == (m, N4) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) < 1e-8


def test_k4_k5_cpu_wrappers_take_the_plain_path(int_weights):
    """No launch on CPU tensors; the format dispatch sends Q6_K/Q8_0 to K4/K5."""
    _, w = int_weights
    before = (tq.int8_matvec.launches, tq.dequant_gemm.launches)
    x = torch.from_numpy(RNG.standard_normal((1, K)).astype(np.float32))
    assert torch.equal(tq.matvec(x, w), tq.int8_matvec_plain(x, w))
    assert torch.equal(tq.gemm(x.repeat(3, 1), w), tq.dequant_gemm_plain(x.repeat(3, 1), w))
    assert (tq.int8_matvec.launches, tq.dequant_gemm.launches) == before
    with pytest.raises(ValueError):
        tq.int8_matvec(x.to("meta"), w)
    with pytest.raises(ValueError):
        tq.dequant_gemm(torch.zeros(2, K + 256), w)


def test_unported_shapes_and_formats_raise(weights):
    """K4/K5 take what zllm's Pallas path takes (K % 256, N % 128) and only
    their formats; the linear dispatch raises for a weight it has no kernel
    for (Q8_K, which neither package repacks)."""
    from zllm_torch.ops.linear import linear
    from zllm_torch.quant.repack import Q80Weight

    w = Q80Weight((256, 64), qs=torch.zeros(64, 256, dtype=torch.int8),
                  d=torch.zeros(64, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="N % 128"):
        tq.int8_matvec(torch.zeros(1, 256), w)
    with pytest.raises(NotImplementedError):
        tq.int8_matvec(torch.zeros(1, K), weights[1])  # Q4_K belongs to K1
    with pytest.raises(NotImplementedError):
        tq.q4k_gemm(torch.zeros(2, 256), w)  # and Q8_0 to K5

    class Q8KWeight(Q80Weight):
        fmt = GGMLType.Q8_K

    w2 = Q8KWeight((256, 128), qs=torch.zeros(128, 256, dtype=torch.int8),
                    d=torch.zeros(128, 8, dtype=torch.float16))
    with pytest.raises(NotImplementedError):
        linear(torch.zeros(1, 256), w2)
    with pytest.raises(NotImplementedError):
        linear(torch.zeros(4, 256), w2)
