"""K12 (`q4k_matvec_hbm`) and the `ZLLM_QMM_HBM=1` switch, on the CPU.

With the switch on, `matvec` sends a Q4_K weight to K12 (whose plain
version is K1's) and Q6_K/Q8_0 weights still to K4; a format no kernel
takes raises.  (K12's Q4_0/Q4_1 forms: tests/test_torch_q4_legacy.py.)
K12's CPU result is held to zllm's `_qmm_w4a8np_hbm_call` run with
interpret=True on the same planes (an npack Q4_K weight, K = N = 512,
tn = tk = 256, as tests/test_npack.py sets them up), for the "q", "norm"
and "glu" prologues, at nmse < 1e-8: the group dots are exact integers on
both sides, and only the f32 sum order differs (plus an ulp of rsqrt in
the "norm" prologue)."""

import numpy as np
import pytest
import torch
from test_torch_oracle import nmse, q4k_qtensor, qtensor_numpy, quant_qtensor, to_np

from zllm.gguf.constants import GGMLType

from zllm_torch.models.loader import params_from_jax
from zllm_torch.ops import qmatmul as tq

K = N = 512


@pytest.fixture(scope="module")
def weights():
    qt, _ = q4k_qtensor(N, K, seed=9, npack=True)
    w = params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")["output"]
    return qt, w


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tq, name)

    def spy(*args, **kw):
        calls.append(name)
        return real(*args, **kw)

    monkeypatch.setattr(tq, name, spy)
    return calls


@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_k12_matches_pallas_hbm_kernel(weights, fuse, monkeypatch):
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    monkeypatch.setenv("ZLLM_QMM_HBM", "1")
    qt, w = weights
    rng = np.random.default_rng(5)
    names = qmm._plane_names(qt)
    pt = tuple(qmm._plane_view(qt, nm) for nm in names)
    kw = dict(fmt=qt.fmt, fold=qt.fold, k=K, n=N, tn=256, tk=256, fuse=fuse,
              diet=names is qmm._Q4K_DIET, interpret=True)
    eps, aux = 1e-5, None
    if fuse == "norm":
        x = rng.standard_normal((1, K)).astype(np.float32)
        wn = rng.standard_normal((1, K)).astype(np.float32)
        want = qmm._qmm_w4a8np_hbm_call(jnp.asarray(x), jnp.asarray(wn), pt, eps=eps, **kw)
        aux = torch.from_numpy(wn.reshape(K))
    else:
        x = rng.standard_normal((1, 2 * K if fuse == "glu" else K)).astype(np.float32)
        want = qmm._qmm_w4a8np_hbm_call(jnp.asarray(x), None, pt, **kw)
    hbm, k1 = _spy(monkeypatch, "q4k_matvec_hbm"), _spy(monkeypatch, "q4k_matvec")
    got = tq.matvec(torch.from_numpy(x), w, fuse, aux, eps)
    assert hbm == ["q4k_matvec_hbm"] and k1 == []
    assert tuple(got.shape) == (1, N) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) < 1e-8
    # K12's plain version is K1's
    assert torch.equal(got, tq.q4k_matvec_plain(torch.from_numpy(x), w, fuse, aux, eps))


@pytest.mark.parametrize("value", [None, "0"])
def test_switch_off_routes_to_k1(weights, monkeypatch, value):
    if value is None:
        monkeypatch.delenv("ZLLM_QMM_HBM", raising=False)
    else:
        monkeypatch.setenv("ZLLM_QMM_HBM", value)
    hbm, k1 = _spy(monkeypatch, "q4k_matvec_hbm"), _spy(monkeypatch, "q4k_matvec")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, K)).astype(np.float32))
    tq.matvec(x, weights[1])
    assert k1 == ["q4k_matvec"] and hbm == []


def test_switch_is_read_at_each_dispatch(weights, monkeypatch):
    """Flipping the variable between two calls moves the next call."""
    hbm, k1 = _spy(monkeypatch, "q4k_matvec_hbm"), _spy(monkeypatch, "q4k_matvec")
    x = torch.ones(1, K)
    monkeypatch.setenv("ZLLM_QMM_HBM", "1")
    tq.matvec(x, weights[1])
    monkeypatch.setenv("ZLLM_QMM_HBM", "0")
    tq.matvec(x, weights[1])
    assert hbm == ["q4k_matvec_hbm"] and k1 == ["q4k_matvec"]


@pytest.mark.parametrize("fmt", [GGMLType.Q6_K, GGMLType.Q8_0], ids=lambda t: t.name)
def test_int8_formats_keep_k4_under_the_switch(fmt, monkeypatch):
    monkeypatch.setenv("ZLLM_QMM_HBM", "1")
    qt, _ = quant_qtensor(fmt, 256, K, seed=11)
    w = params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")["output"]
    k4, hbm = _spy(monkeypatch, "int8_matvec"), _spy(monkeypatch, "q4k_matvec_hbm")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, K)).astype(np.float32))
    got = tq.matvec(x, w)
    assert k4 == ["int8_matvec"] and hbm == []
    assert torch.equal(got, tq.int8_matvec_plain(x, w))


def test_other_formats_raise_under_the_switch(monkeypatch):
    """A format no kernel takes (Q8_K) raises under the switch; K12 itself
    refuses a Q2_K weight (it takes Q4_K, Q4_0 and Q4_1 only; `matvec`
    sends Q2_K to K4)."""
    from zllm_torch.quant.repack import Q80Weight, repack

    class Q8KWeight(Q80Weight):
        fmt = GGMLType.Q8_K

    monkeypatch.setenv("ZLLM_QMM_HBM", "1")
    w = Q8KWeight((256, 128), qs=torch.zeros(128, 256, dtype=torch.int8),
                  d=torch.zeros(128, 8, dtype=torch.float16))
    with pytest.raises(NotImplementedError, match="not Q8_K"):
        tq.matvec(torch.zeros(1, 256), w)
    _, raw = quant_qtensor(GGMLType.Q2_K, 128, 256, seed=3)
    with pytest.raises(NotImplementedError, match="not Q2_K"):
        tq.q4k_matvec_hbm(torch.zeros(1, 256), repack(raw, (128, 256), GGMLType.Q2_K, "cpu"))


def test_k12_wrapper_checks(weights):
    """The same argument checks as K1; other devices raise."""
    _, w = weights
    before = tq.q4k_matvec_hbm.launches
    x = torch.ones(1, K)
    assert torch.equal(tq.q4k_matvec_hbm(x, w), tq.q4k_matvec_plain(x, w))
    assert tq.q4k_matvec_hbm.launches == before
    with pytest.raises(ValueError):
        tq.q4k_matvec_hbm(torch.zeros(1, K + 1), w)
    with pytest.raises(ValueError):
        tq.q4k_matvec_hbm(x, w, fuse="norm")  # no norm weight
    with pytest.raises(ValueError, match="no kernel"):
        tq.q4k_matvec_hbm(x.to("meta"), w)


@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_k12_card_path_is_one_launch(weights, monkeypatch, fuse):
    """The wrapper's card path, with the device checks and the library
    stubbed: each call binds zt_q4k_matvec_hbm (K1's C arguments) and calls
    it once, with the prologue's code and the norm weight only for "norm";
    `.launches` counts one a call."""
    from zllm_torch.ops import cuda

    _, w = weights
    seen = []

    def fake_bind(lib, symbol, argtypes):
        def fn(*args):
            seen.append((lib, symbol, list(argtypes), args))
            return 0
        return fn

    monkeypatch.setattr(tq, "_check_cuda_x", lambda *a: None)
    monkeypatch.setattr(tq, "_check_qweight", lambda *a: None)
    monkeypatch.setattr(cuda, "require_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(cuda, "bind", fake_bind)
    monkeypatch.setattr(cuda, "stream", lambda: 7)
    x = torch.ones(1, 2 * K if fuse == "glu" else K).to("meta")
    aux = torch.ones(K) if fuse == "norm" else None
    before = tq.q4k_matvec_hbm.launches
    y = tq.q4k_matvec_hbm(x, w, fuse, aux, 1e-5)
    assert tuple(y.shape) == (1, N) and tq.q4k_matvec_hbm.launches == before + 1
    (lib, symbol, argtypes, args), = seen
    assert (lib, symbol, argtypes) == ("q4k_matvec_hbm", "zt_q4k_matvec_hbm",
                                       tq.NIBBLE_MATVEC_ARGTYPES)
    assert args[0] == tq.NIBBLE_FMT_CODE[GGMLType.Q4_K] and args[2] == 0
    assert args[3] == (aux.data_ptr() if fuse == "norm" else None)
    assert args[4:9] == tuple(p.data_ptr() for p in w.planes().values())
    assert args[10:] == (K, N, tq.FUSE_CODE[fuse], 1e-5, 7)


@pytest.mark.parametrize("k", [2048, 5632, 8192])
def test_k12_layout_query(monkeypatch, k):
    """`q4k_matvec_hbm_layout` passes K to the library's layout query and
    returns the two numbers it writes back."""
    from zllm_torch.ops import cuda

    def fake_bind(lib, symbol, argtypes):
        assert (lib, symbol) == ("q4k_matvec_hbm", "zt_q4k_matvec_hbm_layout")

        def fn(k_, stages, smem):
            stages._obj.value, smem._obj.value = 2, k_ + k_ // 4 + 7
            return 0
        return fn

    monkeypatch.setattr(cuda, "bind", fake_bind)
    assert tq.q4k_matvec_hbm_layout(k) == (2, k + k // 4 + 7)
