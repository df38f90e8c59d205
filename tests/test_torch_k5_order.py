"""K5's plain version (`dequant_gemm_plain`) in zllm's sum order, against
zllm's `_qmm_kernel` (`qmatmul` with interpret=True: Q6_K and Q8_0 reach
`_qmm_call` for M > 1) on the same weights, repacked by zllm and carried
across by `params_from_jax`.

zllm adds one f32 partial per k-step to its output in k order, the step
512 wide when K % 512 == 0 (else 256); the plain version adds the same
slices' products in the same order.  Inside a slice both sum exact bf16
products in f32, each in its own order, so the tolerance is nmse <= 1e-10
(f32 reassociation of a 256- or 512-term dot)."""

import numpy as np
import pytest
import torch
from test_torch_oracle import nmse, qtensor_numpy, quant_qtensor, to_np

from zllm.gguf.constants import GGMLType

from zllm_torch.models.loader import params_from_jax
from zllm_torch.ops import qmatmul as tq

FMTS = [GGMLType.Q6_K, GGMLType.Q8_0]


@pytest.fixture(scope="module")
def weights():
    """(fmt, K, N) -> (zllm QTensor, the port's QWeight), built once."""
    cache = {}

    def get(fmt, k, n):
        key = (fmt, k, n)
        if key not in cache:
            qt, _ = quant_qtensor(fmt, n, k, seed=k + n + int(fmt))
            w = params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")
            cache[key] = qt, w["output"]
        return cache[key]

    return get


def test_slice_width_is_zllms_k_step():
    assert [tq.slice_width(k) for k in (256, 512, 768, 2048, 5632)] == [256, 512, 256, 512, 512]


@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("n", [256, 384])
@pytest.mark.parametrize("k", [768, 2048, 5632])
@pytest.mark.parametrize("m", [4, 37, 512])
def test_k5_plain_sums_slices_as_zllm(weights, m, k, n, fmt, xdtype):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qt, w = weights(fmt, k, n)
    x = np.random.default_rng(m * k + n).standard_normal((m, k)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if xdtype == "bf16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    want = qmm.qmatmul(xj, qt, interpret=True)
    got = tq.dequant_gemm(xt, w)
    assert tuple(got.shape) == (m, n) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) <= 1e-10


def test_k5_plain_adds_slices_in_order():
    """Each slice's product is added to the running sum in k order: the
    result equals that fold bit for bit, whatever the M."""
    from zllm_torch.quant import blocks as qb
    from zllm_torch.quant.repack import repack

    k, n = 1536, 128
    rng = np.random.default_rng(3)
    raw = qb.quantize(rng.standard_normal((n, k)).astype(np.float32), GGMLType.Q6_K)
    w = repack(raw, (n, k), GGMLType.Q6_K, "cpu")
    x = torch.from_numpy(rng.standard_normal((9, k)).astype(np.float32))
    xb = x.to(torch.bfloat16).float()
    wb = w.dequant_nk().to(torch.bfloat16).float()
    want = torch.zeros(9, n)
    for s in range(0, k, 512):
        want += xb[:, s:s + 512] @ wb[:, s:s + 512].t()
    got = tq.dequant_gemm_plain(x, w)
    assert torch.equal(got, want)
    assert torch.equal(tq.dequant_gemm_plain(x[:4], w), got[:4])


@pytest.mark.parametrize("m,k,n,form,spb", [
    (4, 2048, 256, 0, 1), (4, 5632, 2048, 0, 1), (4, 2048, 32768, 0, 1),  # engine decode
    (256, 2048, 256, 0, 1),  # wv in a chunk: 4 tiles x 4 slices would idle the SMs
    (256, 5632, 2048, 1, 3), (512, 5632, 2048, 1, 6),  # ffn_down: tiles split over slices
    (256, 2048, 32768, 1, 4), (512, 2048, 32768, 1, 4),  # the head: tiles alone fill
    (37, 768, 256, 0, 1)])
def test_k5_slice_plan(m, k, n, form, spb):
    """The form and split K5 takes on an H100 (132 SMs) for the engine's and
    the Generator's shapes; every split covers whole slices."""
    tk, s, got_form, got_spb = tq.slice_plan(m, k, n, 132)
    assert (tk, s) == (tq.slice_width(k), k // tq.slice_width(k))
    assert (got_form, got_spb) == (form, spb)
    nsplit = -(-s // spb)
    assert (nsplit - 1) * spb < s <= nsplit * spb
