"""The Q5_0/Q5_1/Q5_K slice on the CPU, against zllm.

  * codecs: the port's Q5 decoders are bit-exact and its encoders
    byte-identical to `zllm.quant.blocks`, on Gaussian rows and on edge rows
    (zeros, a constant block, wide rows), and the decoders on random bytes
    (every nibble and fifth-bit position);
  * weights: a loaded `Q50Weight`/`Q51Weight`/`Q5KWeight` dequantizes
    exactly to zllm's repacked weight (`_dq_q5_*` on the split-fold layout,
    `_dequant_npack` on the npack one; Q5_K's fp16-rounded scales on both
    sides), and zllm's QTensors carried across by `params_from_jax` (npack
    and split-fold) hold the very same planes; the qh plane's order holds
    on random codes;
  * kernels (plain versions, f32) against zllm's Pallas kernels run with
    interpret=True on the same weight (K = N = 512): K1 against
    `_qmm_w4a8np_call` ("q", "norm", "glu") on the npack layout and against
    `_qmm_w4a8_call` on the split-fold one (zllm's route for a weight with
    N % 256 != 0), K3 against `_qmm_np_call` (M = 4 and 40) and `_qmm_call`.
    All at nmse < 1e-8: the group dots are exact integers on both sides
    (|pi| <= 32 * 31 * 127) and the f32 epilogues are the same expressions,
    so only the f32 sum order differs (plus an ulp of rsqrt in "norm"); K3
    rounds x and w to bf16 on both sides.  K3's rows at M = 4 match the same
    rows of an M = 512 call (bit for bit on the card; here up to the CPU
    matmul's sum order);
  * the dispatch of `matvec` under ZLLM_QMM_HBM and ZLLM_QMM_DUALDOT: a Q5
    weight stays on K1 (zllm's `_hbm_np_ok` refuses a qh plane, and its K11
    takes Q4_0/Q4_1 only); K12 and K11 called directly raise;
  * whole models: 2-layer llama files from the port's factory in Q5_0 and
    Q5_1 and a Q5_K_M file by `zllm_torch.quantize` from an F16 one, zllm
    with its kernels installed in interpret mode (its wk and wv, N = 128,
    are not npack there: K4/K5's `_qmm_w4a8_call`/`_qmm_call`), prefill
    logits and 16 teacher-forced decode-step logits (f32 caches) within
    nmse 2e-4 (the Q4 slices' tolerance) and the free-running greedy tokens
    identical to zllm's; the port's Engine on the Q5_K_M file (paged KV)
    gives zllm's tokens, counters and logits (nmse <= 1e-4)."""

import time

import numpy as np
import pytest
import torch
from test_torch_oracle import (SMALL_LLAMA, f16_llama_gguf, nibble_qtensor, nmse, qtensor_numpy,
                               to_np)

from zllm.gguf.constants import GGMLType

from zllm_torch.models.loader import params_from_jax
from zllm_torch.ops import qmatmul as tq

FMTS = [GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q5_K]
K = N = 512
# GGUF block bytes and the offsets of the fp16 scales: Q5_0 d, then 4 bytes
# of fifth bits and 16 of nibbles; Q5_1 d, m, then 4 + 16; Q5_K d, dmin, 12
# packed 6-bit scales, 32 bytes of fifth bits and 128 of nibbles
BLOCKS = {GGMLType.Q5_0: (22, (0,)), GGMLType.Q5_1: (24, (0, 2)), GGMLType.Q5_K: (176, (0, 2))}


def _carried(qt):
    return params_from_jax({"output": qtensor_numpy(qt), "layers": []}, device="cpu")["output"]


@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
@pytest.mark.parametrize("case", ["gauss", "zeros", "const", "wide"])
def test_codecs_match_zllm(fmt, case):
    from zllm.quant import blocks as zqb
    from zllm_torch.quant import blocks as tqb

    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 512)).astype(np.float32)
    if case == "zeros":
        x[::2] = 0.0
    elif case == "const":
        x[:, :32] = -1.5  # a constant block: max == min
        x[1::2, :256] = 0.25  # a constant superblock
    elif case == "wide":
        x *= np.float32(1e3) * (rng.random((64, 1)) > 0.5)
    enc = tqb.quantize(x, fmt)
    assert np.array_equal(enc, zqb.quantize(x, fmt))
    dec = tqb.dequantize(enc, fmt)
    assert dec.dtype == np.float32 and np.array_equal(dec, zqb.dequantize(enc, fmt))


@pytest.mark.parametrize("fmt", FMTS, ids=lambda t: t.name)
def test_decoders_random_bytes_bit_exact(fmt):
    from zllm.quant import blocks as zqb
    from zllm_torch.quant import blocks as tqb

    size, scales = BLOCKS[fmt]
    rng = np.random.default_rng(size)
    raw = rng.integers(0, 256, size=(64, size), dtype=np.uint8)
    for off in scales:
        raw[:, off:off + 2] = rng.uniform(-0.05, 0.05, 64).astype(np.float16).view(
            np.uint8).reshape(-1, 2)
    assert np.array_equal(tqb.dequantize(raw, fmt), zqb.dequantize(raw, fmt))


@pytest.fixture(scope="module", params=FMTS, ids=lambda t: t.name)
def weights(request):
    """(npack QTensor, split-fold QTensor, the port's loaded weight) of one
    random weight."""
    from zllm_torch.quant.repack import repack

    fmt = request.param
    qn, raw = nibble_qtensor(fmt, N, K, seed=17, npack=True)
    qf, _ = nibble_qtensor(fmt, N, K, seed=17, npack=False)
    return qn, qf, repack(raw, (N, K), fmt, "cpu")


def test_loaded_and_carried_weights_match_zllm(weights):
    import jax.numpy as jnp

    from zllm.quant import blocks as zqb

    qn, qf, w = weights
    raw = nibble_qtensor(qn.fmt, N, K, seed=17, npack=False)[1]
    dense = w.dequant_nk()
    ggml = torch.from_numpy(zqb.dequantize(raw, qn.fmt).reshape(N, K))
    if qn.fmt == GGMLType.Q5_K:  # zllm's repack rounds d * sc and dmin * mn to fp16
        assert not torch.equal(dense, ggml) and nmse(dense, ggml) < 1e-5
    else:
        assert torch.equal(dense, ggml)
    assert 0 < int((w.codes() >> 4).sum()) < N * K  # the fifth bits are random
    for qt in (qn, qf):
        c = _carried(qt)
        assert type(c) is type(w) and c.shape == w.shape
        assert all(torch.equal(p, w.planes()[name]) for name, p in c.planes().items())
        assert np.array_equal(to_np(c.dequant()), np.asarray(qt.dequant(jnp.float32)))


def test_qh_order_round_trips():
    """Random codes 0..31 -> planes -> codes; bit i of qh byte 8c + 4p + 2h
    + t is the fifth bit of code 64c + 32h + 16p + 8t + i."""
    from zllm_torch.quant.repack import Q5Weight, from_planes

    codes = np.random.default_rng(2).integers(0, 32, size=(8, 512), dtype=np.uint8)
    planes = Q5Weight.pack_codes(codes)
    w = from_planes({**planes, "d": np.ones((8, 16), "<f2")}, (512, 8), GGMLType.Q5_0, "cpu")
    assert np.array_equal(w.codes().numpy(), codes)
    c, p, h, t, i = 3, 1, 1, 0, 5
    assert (planes["qh"][2, 8 * c + 4 * p + 2 * h + t] >> i) & 1 == codes[
        2, 64 * c + 32 * h + 16 * p + 8 * t + i] >> 4
    words = planes["qh"].view("<u4")  # the u32 word 2c + p a K1 lane reads
    j = 11
    assert (words[2, 2 * c + p] >> j) & 1 == codes[2, 64 * c + 16 * p + j] >> 4
    assert (words[2, 2 * c + p] >> (16 + j)) & 1 == codes[2, 64 * c + 32 + 16 * p + j] >> 4


def test_layout_operations_keep_values(weights):
    """permute_n, concat_n and pad_n move whole columns, qh rows with them."""
    from zllm_torch.quant.repack import concat_n, pad_n

    _, _, w = weights
    dense = w.dequant()
    perm = np.random.default_rng(1).permutation(N)
    assert torch.equal(w.permute_n(perm).dequant(), dense[:, perm])
    assert torch.equal(concat_n([w, w]).dequant(), torch.cat([dense, dense], dim=1))
    padded = pad_n(w, 1024)
    assert padded.shape == (K, 1024) and torch.equal(padded.dequant()[:, :N], dense)
    assert not padded.dequant()[:, N:].any()


def _x(fuse, seed):
    rng = np.random.default_rng(seed)
    if fuse == "norm":
        x = (rng.standard_normal((1, K)) * 3.0).astype(np.float32)
        return x, (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    return rng.standard_normal((1, 2 * K if fuse == "glu" else K)).astype(np.float32), None


@pytest.mark.parametrize("layout", ["npack", "fold"])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_k1_plain_matches_pallas(weights, fuse, layout):
    """npack: `_qmm_w4a8np_call` (zllm's K1); fold: `_qmm_w4a8_call`."""
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qn, qf, w = weights
    qt = qn if layout == "npack" else qf
    x, wn = _x(fuse, 5)
    if fuse == "norm":
        want = qmm.qmatvec_norm(jnp.asarray(x), jnp.asarray(wn), 1e-5, qt, interpret=True)
        got = tq.q4k_matvec(torch.from_numpy(x), w, "norm", torch.from_numpy(wn), 1e-5)
    elif fuse == "glu":
        want = qmm.qmatvec_glu(jnp.asarray(x), qt, interpret=True)
        got = tq.q4k_matvec(torch.from_numpy(x), w, "glu")
    else:
        want = qmm.qmatmul_w4a8(jnp.asarray(x), qt, interpret=True)
        got = tq.q4k_matvec(torch.from_numpy(x), w)
    assert tuple(got.shape) == (1, N) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) < 1e-8


@pytest.mark.parametrize("layout", ["npack", "fold"])
@pytest.mark.parametrize("m", [4, 40])
def test_k3_plain_matches_pallas(weights, m, layout):
    """npack: `_qmm_np_call` (zllm's K3); fold: `_qmm_call`."""
    import jax.numpy as jnp

    from zllm.ops import qmatmul as qmm

    qn, qf, w = weights
    x = np.random.default_rng(m).standard_normal((m, K)).astype(np.float32)
    want = qmm.qmatmul(jnp.asarray(x), qn if layout == "npack" else qf, interpret=True)
    got = tq.q4k_gemm(torch.from_numpy(x), w)
    assert tuple(got.shape) == (m, N) and got.dtype == torch.float32
    assert nmse(to_np(got), to_np(want)) < 1e-8


def test_k3_rows_at_m4_match_rows_at_m512(weights):
    """The plain version sums every row slice by slice, as the kernel does,
    so the rows of an M = 4 call are those of an M = 512 call up to the
    order in which the CPU's matmul sums a slice's 512 exact products (the
    kernel's rows are equal bit for bit: `tests/test_torch_cuda.py::
    test_k3_k5_rows_do_not_depend_on_m`, on the card)."""
    _, _, w = weights
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((512, K)).astype(np.float32))
    full = tq.q4k_gemm(x, w)
    for rows in (slice(0, 4), slice(508, 512)):
        assert nmse(tq.q4k_gemm(x[rows], w), full[rows]) < 1e-13


@pytest.mark.parametrize("hbm,dualdot", [(None, None), ("1", None), (None, "1"), ("1", "1")])
@pytest.mark.parametrize("fuse", ["q", "norm", "glu"])
def test_dispatch_keeps_q5_on_k1(weights, monkeypatch, hbm, dualdot, fuse):
    """Every prologue of a Q5 weight goes to K1 whatever the switches say."""
    for name, val in (("ZLLM_QMM_HBM", hbm), ("ZLLM_QMM_DUALDOT", dualdot)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    calls = []
    for name in ("q4k_matvec", "q4k_matvec_hbm", "w4a8dd_matvec", "int8_matvec"):
        real = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda *a, _n=name, _r=real, **kw: (calls.append(_n),
                                                                          _r(*a, **kw))[1])
    _, _, w = weights
    x, wn = _x(fuse, 7)
    aux = None if wn is None else torch.from_numpy(wn)
    got = tq.matvec(torch.from_numpy(x), w, fuse, aux, 1e-5)
    assert calls == ["q4k_matvec"]
    assert torch.equal(got, tq.q4k_matvec_plain(torch.from_numpy(x), w, fuse, aux, 1e-5))
    assert torch.equal(tq.gemm(torch.from_numpy(x[:, :K]), w),
                       tq.q4k_gemm_plain(torch.from_numpy(x[:, :K]), w))


def test_k12_and_k11_refuse_q5(weights):
    _, _, w = weights
    x = torch.ones(1, K)
    with pytest.raises(NotImplementedError, match=f"K12 take .* not {w.fmt.name}"):
        tq.q4k_matvec_hbm(x, w)
    with pytest.raises(NotImplementedError, match=f"K11 take .* not {w.fmt.name}"):
        tq.w4a8dd_matvec(x, w)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k1_k3_pass_qh_as_s3(weights, monkeypatch, xdtype):
    """The wrappers' card paths, with the device checks and the library
    stubbed: K1 and K3 get the format's code, qs, the scale planes as s0
    (s1) and qh as s3."""
    from zllm_torch.ops import cuda

    _, _, w = weights
    seen = []

    def fake_bind(lib, symbol, argtypes):
        def fn(*args):
            seen.append((symbol, args))
            return 0
        return fn

    monkeypatch.setattr(tq, "_check_cuda_x", lambda *a: None)
    monkeypatch.setattr(tq, "_check_qweight", lambda *a: None)
    monkeypatch.setattr(tq, "_gemm_cuda_x", lambda x, w_: torch.empty(x.shape[0], w_.shape[1]))
    monkeypatch.setattr(tq, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda, "require_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(cuda, "bind", fake_bind)
    monkeypatch.setattr(cuda, "stream", lambda: 7)
    scales = [w.d] if w.fmt == GGMLType.Q5_0 else [w.a, w.b]
    want = [w.qs.data_ptr(), *[p.data_ptr() for p in scales], *[None] * (3 - len(scales)),
            w.qh.data_ptr()]
    tq.q4k_matvec(torch.ones(1, K, dtype=xdtype).to("meta"), w)
    tq.q4k_gemm(torch.ones(4, K, dtype=xdtype).to("meta"), w)
    (s1, a1), (s2, a2) = seen
    assert (s1, s2) == ("zt_q4k_matvec", "zt_q4k_gemm")
    assert a1[0] == a2[0] == tq.NIBBLE_FMT_CODE[w.fmt] == {GGMLType.Q5_0: 3, GGMLType.Q5_1: 4,
                                                          GGMLType.Q5_K: 5}[w.fmt]
    assert list(a1[4:9]) == want and list(a2[4:9]) == want


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

SHAPE = {k: v for k, v in SMALL_LLAMA.items() if k != "gtype"}
PROMPT = [1] + list(range(40, 59))  # 20 tokens: two 16-token prefill chunks
N_DECODE = 16
MODEL_FTYPES = ["Q5_0", "Q5_1", "Q5_K_M"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Q5_0 and Q5_1 from the port's factory; Q5_K_M by zllm_torch.quantize
    from an F16 file (wq, wk, wo, gate, up, down Q5_K; wv, head Q6_K)."""
    from zllm_torch.quantize import quantize_file
    from zllm_torch.testing import make_llama_gguf

    folder = tmp_path_factory.mktemp("q5")
    out = {ft: make_llama_gguf(str(folder / f"{ft}.gguf"), **SHAPE, gtype=GGMLType[ft],
                               with_tokenizer=True) for ft in ("Q5_0", "Q5_1")}
    out["Q5_K_M"] = str(folder / "Q5_K_M.gguf")
    types = quantize_file(f16_llama_gguf(str(folder / "f16.gguf"), seed=1), out["Q5_K_M"],
                          "Q5_K_M", quiet=True)
    assert types["blk.1.attn_k.weight"][1] == "Q5_K" and types["output.weight"][1] == "Q6_K"
    return out


@pytest.fixture(scope="module")
def zllm_runs(files):
    """zllm's prefill and teacher-forced decode logits (f32 cache, its own
    greedy tokens), with its kernels installed in interpret mode."""
    import jax.numpy as jnp

    from zllm.models.loader import Model
    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.runtime.generate import Generator

    out = {}
    qmatmul.install(interpret=True)
    try:
        for ftype, path in files.items():
            gen = Generator(Model.load(path, dtype=jnp.float32), max_len=256, prefill_chunk=16,
                            kv_dtype=jnp.float32)
            logits = [to_np(gen.prefill(PROMPT))]
            toks = [int(np.argmax(logits[0]))]
            for i in range(N_DECODE):
                tok = jnp.full((1, 1), toks[-1], jnp.int32)
                pos = jnp.full((1, 1), len(PROMPT) + i, jnp.int32)
                lg, gen.kv = gen._step(tok, pos, gen.kv, logits_for="last")
                logits.append(to_np(lg[0, -1]))
                toks.append(int(np.argmax(logits[-1])))
            out[ftype] = logits, toks
    finally:
        linmod.set_fused_matmul(None)
        linmod.set_fused_decode(None, None)
    return out


@pytest.mark.parametrize("ftype", MODEL_FTYPES)
def test_model_matches_zllm(files, zllm_runs, monkeypatch, ftype):
    from zllm_torch.models.loader import Model
    from zllm_torch.quant.repack import Q5Weight
    from zllm_torch.runtime.generate import Generator

    launched = {"q4k_matvec": 0, "q4k_gemm": 0}
    for name in launched:
        real = getattr(tq, name)

        def spy(*a, _n=name, _r=real, **kw):
            launched[_n] += 1
            return _r(*a, **kw)

        monkeypatch.setattr(tq, name, spy)
    zlog, ztoks = zllm_runs[ftype]
    m = Model.load(files[ftype], device="cpu", dtype=torch.float32)
    layer = m.params["layers"][0]
    assert isinstance(layer["wk"] if ftype == "Q5_K_M" else layer["wqkv"], Q5Weight)
    gen = Generator(m, max_len=256, prefill_chunk=16, kv_dtype=torch.float32)
    tlog = [to_np(gen.prefill(PROMPT))]
    toks = [int(np.argmax(tlog[0]))]
    for i in range(N_DECODE):  # fed zllm's tokens; the port's own greedy picks recorded
        tlog.append(to_np(gen._decode_one(ztoks[i], len(PROMPT) + i)))
        toks.append(int(np.argmax(tlog[-1])))
    for step, (a, b) in enumerate(zip(tlog, zlog)):
        assert a.shape == b.shape == (SHAPE["vocab_size"],)
        assert nmse(a, b) <= 2e-4, f"step {step}: nmse {nmse(a, b)}"
    assert launched["q4k_matvec"] > 0 and launched["q4k_gemm"] > 0
    assert toks == ztoks
    gen.reset()
    free = gen.generate(PROMPT, max_new=N_DECODE + 1)
    assert free.tokens == ztoks


def test_engine_matches_zllm(files, monkeypatch):
    """zllm's engine with its kernels in interpret mode against the port's
    (K1's and K3's plain versions) on the Q5_K_M file, paged f32 KV: the
    same tokens, finish reasons, reuse and step counters, and every sampled
    logits row within 1e-4 of zllm's."""
    import jax.numpy as jnp

    from zllm.models.loader import Model as ZModel
    from zllm.ops import linear as linmod
    from zllm.ops import qmatmul
    from zllm.server.engine import Engine as ZEngine
    from zllm.server.engine import Request as ZRequest
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request

    counters = ("tokens_generated_total", "tokens_prefilled_total", "tokens_prefix_reused_total",
                "decode_steps_total", "prefill_steps_total", "engine_errors_total")
    logits = {"zllm": {}, "port": {}}
    for side, cls in (("zllm", ZEngine), ("port", Engine)):
        real = cls._sample_and_emit

        def record(self, lg, cols, slots, _real=real, _rec=logits[side]):
            rows = to_np(lg)
            for s in slots:
                _rec.setdefault(tuple(s.req.prompt_tokens), []).append(
                    rows[s.idx, int(cols[s.idx])])
            return _real(self, lg, cols, slots)

        monkeypatch.setattr(cls, "_sample_and_emit", record)
    r = np.random.default_rng(5)
    long = [int(t) for t in r.integers(3, 500, size=140)]  # crosses the first 128-token page
    waves = [[dict(prompt_tokens=[int(t) for t in r.integers(3, 500, size=37)], max_new=6),
              dict(prompt_tokens=long, max_new=6)],
             [dict(prompt_tokens=long[:130] + [7], max_new=4)]]
    path = files["Q5_K_M"]
    out = {}
    qmatmul.install(interpret=True)
    try:
        for side, eng, make_request in (
                ("zllm", ZEngine(ZModel.load(path, dtype=jnp.float32), n_slots=2, max_len=256,
                                 prefill_chunk=16, kv_dtype=jnp.float32),
                 lambda **kw: ZRequest(temp=0.0, **kw)),
                ("port", Engine(Model.load(path, device="cpu", dtype=torch.float32), n_slots=2,
                                max_len=256, prefill_chunk=16, kv_dtype=torch.float32),
                 lambda **kw: Request(temp=0.0, **kw))):
            eng.start()
            try:
                before, got = dict(eng.metrics), []
                for wave in waves:
                    # submitted from the engine thread between two steps, so
                    # both engines admit a wave at the same step
                    reqs = eng.run_in_loop(lambda wave=wave: [eng.submit(make_request(**kw))
                                                              for kw in wave])
                    deadline = time.time() + 300
                    while not all(q.done for q in reqs):
                        assert time.time() < deadline, "engine timed out"
                        time.sleep(0.005)
                    got += [(tuple(q.prompt_tokens), list(q.out_tokens), q.finish_reason,
                             q.n_prompt_reused, q.error) for q in reqs]
                out[side] = got, {k: eng.metrics[k] - before[k] for k in counters}
            finally:
                eng.stop()
    finally:
        linmod.set_fused_matmul(None)
        linmod.set_fused_decode(None, None)
    (tgot, tcount), (zgot, zcount) = out["port"], out["zllm"]
    assert all(err == "" for *_, err in tgot), tgot
    assert tgot == zgot and tcount == zcount
    for prompt, toks, *_ in tgot:
        trows, zrows = logits["port"][prompt], logits["zllm"][prompt]
        assert len(trows) == len(zrows) == len(toks)
        for step, (a, b) in enumerate(zip(trows, zrows)):
            assert nmse(a, b) <= 1e-4, (step, nmse(a, b))
    assert tcount["decode_steps_total"] > 0 and tgot[2][3] >= 128
