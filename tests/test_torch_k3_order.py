"""K3 on the sliced loop, on the CPU: its plain version (`q4k_gemm_plain`,
K5's `dequant_gemm_plain`) against zllm's `_qmm_np_kernel` (`qmatmul`
with interpret=True on an npack Q4_K, Q4_0 or Q4_1 QTensor: M > 1 reaches
`_qmm_np_call`), carried across by `params_from_jax`; and the form and
split `slice_plan` picks for K3's shapes, each one the launcher
(`csrc/gemm_slice.cuh::launch_slice_gemm`) takes.

zllm's K3 adds one f32 partial per k-step of 256 x mult (mult the largest
of 8..2 dividing K/256, or 2 where x or the output takes 6-16 MB: K = 768
sums one 768-wide step, 2048 one 2048-wide, 5632 eleven 512-wide ones);
the port adds 512-wide (256 when K % 512 != 0) slices in order, the same
at every M.  Both sum exact products of bf16 values in f32, so the gap is
f32 reassociation of a dot of at most 5632 terms: nmse <= 1e-10."""

import numpy as np
import pytest
import torch
from test_torch_oracle import nibble_qtensor, nmse, qtensor_numpy, to_np

from zllm.gguf.constants import GGMLType

from zllm_torch.models.loader import params_from_jax
from zllm_torch.ops import qmatmul as tq

FMTS = [GGMLType.Q4_K, GGMLType.Q4_0, GGMLType.Q4_1]
N = 256  # zllm takes its npack layout, and so `_qmm_np_call`, for N % 256 == 0


@pytest.fixture(scope="module")
def weights():
    """(fmt, K) -> (zllm npack QTensor, the port's NibbleWeight), built once."""
    cache = {}

    def get(fmt, k):
        if (fmt, k) not in cache:
            qt, _ = nibble_qtensor(fmt, N, k, seed=k + int(fmt))
            w = params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")
            cache[fmt, k] = qt, w["output"]
        return cache[fmt, k]

    return get


@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("k", [768, 2048, 5632])
@pytest.mark.parametrize("m", [4, 37])
def test_k3_plain_sums_slices_near_zllm(weights, m, k, fmt, xdtype):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qt, w = weights(fmt, k)
    assert qt.npack
    x = np.random.default_rng(m * k + int(fmt)).standard_normal((m, k)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if xdtype == "bf16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    want = qmm.qmatmul(xj, qt, interpret=True)
    got = tq.q4k_gemm(xt, w)
    assert tuple(got.shape) == (m, N) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) <= 1e-10


def _launcher_takes(m, k, n, tk, form, spb) -> bool:
    """launch_slice_gemm's own checks (gemm_slice.cuh): any M, any even N
    (the last column block is masked)."""
    return (m > 0 and n > 0 and n % 2 == 0 and tk in (256, 512) and k % tk == 0 and spb >= 1
            and form in (0, 1) and (form == 1 or spb == 1))


@pytest.mark.parametrize("k", [2048, 5632, 8192])
@pytest.mark.parametrize("n", [64, 200, 256, 2560, 11264, 32768])
@pytest.mark.parametrize("m", [1, 4, 7, 256, 512])
def test_k3_slice_plan_takes_launchable_forms(m, k, n):
    """Every plan for K3's shapes (the Q4_K, Q4_K_M, Q4_0 and OLMo-2 Q4_1
    models' weights at the Generator's and the engine's M, and the card
    tests' ragged N) is one the launcher takes, and its splits cover whole
    slices."""
    tk, s, form, spb = tq.slice_plan(m, k, n, 132)
    assert (tk, s) == (tq.slice_width(k), k // tq.slice_width(k))
    assert _launcher_takes(m, k, n, tk, form, spb)
    assert spb <= s
    if m <= tq.ROW_M:
        assert form == 0
    nsplit = -(-s // spb)
    assert (nsplit - 1) * spb < s <= nsplit * spb


@pytest.mark.parametrize("m,k,n,form,spb", [
    (4, 2048, 2048, 0, 1), (4, 2048, 11264, 0, 1), (4, 5632, 2048, 0, 1),  # serve decode
    (256, 2048, 2560, 1, 2),  # wqkv: 40 tiles, slices 2 + 2
    (256, 2048, 2048, 1, 1),  # wo: 32 tiles x 4 slices fill 128 of 132 SMs
    (256, 2048, 11264, 1, 3),  # gate|up: 176 tiles, slices 3 + 1 end sooner than 4
    (256, 5632, 2048, 1, 3), (256, 8192, 2048, 1, 4),  # ffn_down (OLMo-2: 16 slices)
    (256, 2048, 6144, 1, 3), (256, 2048, 16384, 1, 4),  # OLMo-2 wqkv, gate|up
    (256, 2048, 32768, 1, 4), (256, 2048, 100352, 1, 4),  # the heads: tiles alone fill
    (256, 2048, 256, 0, 1),  # wk in a chunk: 4 tiles x 4 slices would idle the SMs
    (44, 2048, 2560, 0, 1), (44, 2048, 11264, 1, 3), (44, 5632, 2048, 0, 1),  # a 44-row chunk
    (512, 2048, 2048, 1, 2), (512, 2048, 11264, 1, 4), (512, 5632, 2048, 1, 6),  # mixed step
    (256, 2048, 200, 0, 1), (37, 512, 64, 0, 1), (300, 2048, 200, 0, 1)])  # ragged N
def test_k3_slice_plan_pins(m, k, n, form, spb):
    """The form and split K3 takes on an H100 (132 SMs), by the cost model
    of `slice_plan`: at the shapes `python -m zllm_torch.k5_ablation
    --plans` times, each pick is within a few percent of the fastest plan
    on the card."""
    assert tq.slice_plan(m, k, n, 132)[2:] == (form, spb)
