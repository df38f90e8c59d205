"""Continuous-batching inference engine (counterpart of
`zllm/server/engine.py::Engine` for dense llama models), in two KV layouts:

  * paged (the default): slots share one page pool through per-slot page
    tables (`runtime/paged.py`; K9 decode, K10 mixed steps);
  * contiguous: one [n_slots, Hkv, max_len + prefill_chunk, D] stripe per
    layer, slot index == position (`runtime/kvcache.py`): bf16/f16/f32 K/V
    (K2 decode, K6 mixed steps; OLMo-2: K8 decode), or the
    int8 q8 cache, `kv_dtype="q8"`, which always takes this layout (K7 at
    every step).  A sliding-window model (Gemma-2/3) under
    `context_shift="auto"` or False serves from the ring cache
    `KVCacheSWA` instead, with no context shift, as zllm does: its full
    layers are such stripes (K2, K6), its windowed layers rings of
    round_up(window + chunk, 128) slots (the plain `attention_ref`); with
    `context_shift=True`, the plain stripe, every kernel windowed.
`kv_layout="auto"` is paged unless `kv_dtype` is "q8"/"q8_0", the model
has a sliding window, or the engine speculates or looks ahead, as in
zllm; an explicit "paged" stays paged for a windowed model (K9 and K10
take each layer's window).

One engine thread runs the steps:
  * prompt chunks and generating slots share one batch: every prompting
    slot's next chunk rides in its own row of an [n_slots, chunk] step and
    a generating slot's token rides in column 0 with trash positions after
    it (one repeated; a prompt chunk pads with distinct ones, so the model
    tells the two apart: `_mixed_step`); with no prompt pending the step
    is [n_slots, 1] (`_decode_step`).  Rows with nothing to do sit at position max_len,
    the trash page or the contiguous stripe's trash region [max_len, S);
  * prompt-prefix reuse (`prefix_reuse=True`): paged, a request shares
    the full 128-token pages of the longest common prefix with any slot's
    cache (even a busy slot's: full pages are immutable); contiguous, it
    reuses the longest common prefix of an idle slot's own cache, in
    place; either way it prefills only the rest;
  * context shift (`context_shift="auto"` or True): a generating slot that
    reaches max_len drops the oldest half of its window (keeping n_keep)
    and re-rotates K in place (q8: dequantized, rotated, requantized),
    after a copy-on-write unshare of pages it shares; with False it
    finishes with "length" there instead;
  * slot state (`save_slot`, `restore_slot`, `erase_slot`, on the engine
    thread): a slot's K/V to a state file (`runtime/state.py`) and back
    into any idle slot, whose next request reuses the restored prefix;
    a paged restore first maps the slot a fresh row of its own, so it
    never writes into pages another slot shares;
  * speculative decoding (`speculative=True`: n-gram prompt lookup;
    `draft_model=`: a draft model's greedy proposals, its own contiguous
    stripe of max_len + prefill_chunk slots): with no prompt pending and a
    greedy, grammar-free slot, one [n_slots, 1 + n_draft] verify step
    (`_spec_decode_step`) carries every slot's decode token in column 0
    and a speculating slot's drafts after it; `forward(..., verify=True)`
    gives each column the decode step's attention bits, so accepted
    output equals plain greedy decode (with n_slots >= 2: a one-slot
    engine's decode step runs the matvec kernels, K1/K4, whose int8
    activations round apart from the verify step's GEMMs, as in zllm);
  * lookahead decoding (`lookahead=True`, la_w / la_n / la_g): greedy
    slots carry their pending tokens, a Jacobi window and verification
    grams in one [n_slots, la_n + (la_w + la_g)(la_n - 1)] step under a
    block mask (`_lookahead_step`; the plain `attention_ref`, so accepted
    tokens equal plain greedy decode up to its f32 rounding on the card);
    accepted tokens not yet in the cache are flushed by one plain step
    before a prompt mixes in or a shift;
  * sampling is one batched chain over all slots with per-slot parameters
    and one torch.Generator per slot (`sampling/batched.py`); grammar
    masking stays on the host, applied by resampling the rows whose first
    draw the grammar refuses;
  * the loop survives step errors: in-flight requests finish with a typed
    error and the engine keeps serving.

The model runs on its own device: a CUDA model's steps launch the port's
kernels (the layout's attention kernels, K3/K5 for the quantized matmuls),
a CPU model's the plain versions.  Invalid settings raise ValueError: an
unknown `kv_dtype` string and q8 with the paged layout, as zllm's do, a
torch dtype other than bf16, f16 or f32, and an unknown layout (which
zllm serves as contiguous); lookahead with speculation, the paged layout,
the q8 cache, multi-device serving or a prefill_chunk narrower than its
step, as zllm's do; and a draft model on another device.  What this engine
does not port raises NotImplementedError naming its ROADMAP item:
tp/dp/pp/mesh and coordinated serving (item 10), media (item 4.8).  A
windowed model refuses the q8 cache and lookahead with zllm's messages.
Recurrent, hybrid and MLA models do not load in zllm_torch at all
(`models/config.py`).
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
import torch

from ..models.llama import PAGED_SINKS, forward
from ..runtime import state
from ..runtime.kvcache import KVCache, KVCacheQ8, KVCacheSWA, shift_context_row
from ..runtime.paged import PageAllocator, PagedKVCache
from ..sampling import batched

PENALTY_WINDOW = 64
NEG_INF = -1e30  # matches sampling.batched.NEG_INF
PAGE_SIZE = 128  # sets which prefixes are shareable (whole pages only)


class Histogram:
    """Prometheus-style cumulative histogram."""

    def __init__(self, buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +Inf
        self.total = 0.0
        self.n = 0

    def observe(self, v: float):
        self.total += v
        self.n += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def prometheus(self, name: str) -> str:
        out, cum = [], 0
        for b, c in zip(self.buckets, self.counts):
            cum += c
            out.append(f'{name}_bucket{{le="{b}"}} {cum}')
        out.append(f'{name}_bucket{{le="+Inf"}} {self.n}')
        out.append(f"{name}_sum {self.total}")
        out.append(f"{name}_count {self.n}")
        return "\n".join(out)


class SlotState(Enum):
    IDLE = 0
    PROMPT = 1  # prefilling
    GENERATING = 2


@dataclass
class Request:
    prompt_tokens: list[int]
    max_new: int = 128
    grammar: object = None  # grammar.GrammarSampler (constrained decoding)
    temp: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    typical_p: float = 1.0
    top_n_sigma: float = 0.0
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    repeat_penalty: float = 1.0
    freq_penalty: float = 0.0
    presence_penalty: float = 0.0
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    mirostat: int = 0  # 0 off, 2 = mirostat-v2 (v1 maps to v2)
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    seed: int = -1
    n_keep: int = 0  # tokens preserved by context shift
    media: list = field(default_factory=list)  # not ported: submit refuses it
    stop_tokens: frozenset = frozenset()
    stop_strings: tuple = ()
    stream_q: "queue.Queue" = field(default_factory=queue.Queue)
    rid: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    # results
    done: bool = False
    out_tokens: list[int] = field(default_factory=list)
    finish_reason: str = ""
    error: str = ""
    n_prompt_reused: int = 0
    stop_trim_chars: int = -1  # char offset of the matched stop string in the text
    _text: str = ""  # decoded-so-far (stop-string scanning only)
    _stopdec: object = None  # IncrementalDecoder for _text
    t_submit: float = field(default_factory=time.time)
    t_first_token: float = 0.0
    t_done: float = 0.0


@dataclass
class _Slot:
    idx: int
    state: SlotState = SlotState.IDLE
    req: Request | None = None
    pos: int = 0  # next absolute position
    prompt_left: list[int] = field(default_factory=list)
    last_token: int = 0
    generated: int = 0
    # tokens whose K/V currently live in this slot's cache [0, pos)
    cache_tokens: list[int] = field(default_factory=list)


def _common_prefix(a: list[int], b: list[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in zllm_torch's engine yet (ROADMAP queue 1 item {item})")


class Engine:
    def __init__(self, model, n_slots: int = 4, max_len: int = 2048, prefill_chunk: int = 128,
                 kv_dtype=None, prefix_reuse: bool = True, context_shift="auto",
                 speculative: bool = False, n_draft: int = 6, kv_layout: str = "auto",
                 draft_model=None, tp: int = 1, dp: int = 1, pp: int = 1, mesh=None,
                 coordinated: bool = False, lookahead: bool = False, la_w: int = 4,
                 la_n: int = 3, la_g: int = 4):
        if kv_layout not in ("auto", "paged", "contiguous"):
            raise ValueError(f"unknown kv_layout {kv_layout!r} (auto, paged or contiguous)")
        # kv_dtype: a torch dtype, or the string "q8"/"q8_0" for the int8
        # cache, which needs the contiguous layout ("auto" picks it, and so
        # it does under speculation and lookahead, as zllm's does)
        quant = isinstance(kv_dtype, str)
        windowed = model.cfg.sliding_window > 0
        if kv_layout == "auto":
            kv_layout = ("contiguous" if quant or windowed or speculative
                         or draft_model is not None or lookahead else "paged")
        if kv_layout == "paged" and any("attn_sinks" in layer
                                        for layer in model.params["layers"]):
            # gpt-oss's sinks: K9 and K10 have no sinks form (zllm's paged
            # route on a TPU drops them)
            raise NotImplementedError(PAGED_SINKS)
        if quant:
            if kv_dtype.lower() not in ("q8", "q8_0"):
                raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (use 'q8' or a torch dtype)")
            if kv_layout == "paged":
                raise ValueError("kv_dtype='q8' requires the contiguous KV layout")
            if windowed:
                raise ValueError("kv_dtype='q8' requires a standard-attention model "
                                 "with the contiguous KV layout")
            kv_dtype = None
        elif kv_dtype not in (None, torch.bfloat16, torch.float16, torch.float32):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (bfloat16, float16, float32 "
                             "or 'q8')")
        # draft-model speculation: a small model drafts the block the target
        # verifies, so drafting implies speculation
        if draft_model is not None:
            speculative = True
            if draft_model.device != model.device:
                raise ValueError(f"the draft model is on {draft_model.device}, the model on "
                                 f"{model.device}")
        # lookahead: greedy slots carry a Jacobi window and verification
        # grams as extra columns under a block mask, their K/V stored in the
        # contiguous stripe's headroom past max_len
        multi = (tp or 1) * (dp or 1) * (pp or 1) > 1 or mesh is not None or coordinated
        if lookahead:
            if speculative:
                raise ValueError("--lookahead and speculative decoding are exclusive")
            if multi:
                raise ValueError("lookahead serving is single-device only")
            if kv_layout == "paged":
                raise ValueError("lookahead requires the contiguous KV layout")
            if quant:
                raise ValueError("lookahead does not support the q8 KV cache")
            if windowed:
                raise ValueError("lookahead supports uniform standard attention only")
        self.la_n, self.la_w, self.la_g = int(la_n), int(la_w), int(la_g)
        if lookahead and (self.la_n < 2 or self.la_w < 1 or self.la_g < 1):
            raise ValueError("lookahead needs la_n >= 2, la_w >= 1, la_g >= 1")
        if lookahead:
            t_spec = self.la_n + (self.la_w + self.la_g) * (self.la_n - 1)
            if t_spec > prefill_chunk:
                raise ValueError(
                    f"lookahead geometry needs {t_spec} spec slots > prefill_chunk "
                    f"({prefill_chunk}) cache headroom")
        if multi:
            raise _not_ported("multi-device serving (tp/dp/pp/mesh, coordinated)", "10")
        self.lookahead = lookahead
        self._la: dict[int, dict] = {}  # per-slot Jacobi window, gram pool, extras
        self.speculative = speculative
        self.draft = draft_model
        self.n_draft = min(n_draft, prefill_chunk - 1)
        self.model = model
        self.device = model.device
        self.n_slots = n_slots
        self.prefix_reuse = prefix_reuse
        self.context_shift = context_shift if context_shift != "auto" else True
        self.prefill_chunk = prefill_chunk
        cfg = model.cfg

        self.paged = kv_layout == "paged"
        if self.paged:
            # shared page pool + per-slot page tables; full prefix pages are
            # shared across slots read-only
            self.max_len = -(-max_len // PAGE_SIZE) * PAGE_SIZE
            self.alloc = PageAllocator(n_slots, self.max_len, PAGE_SIZE)
            for i in range(n_slots):
                self.alloc.assign_slot(i, None, 0)
            self.kv = PagedKVCache.create(
                cfg.n_layers, n_slots, self.max_len, cfg.n_kv_heads, cfg.head_dim,
                kv_dtype or torch.bfloat16, page_size=PAGE_SIZE, device=self.device,
            ).with_table(self.alloc.table)
        else:
            # one stripe per slot, with the trash region [max_len, max_len +
            # prefill_chunk) past the attendable horizon: an inactive row's
            # run of writes from max_len stays inside it
            self.max_len = max_len
            shape = (cfg.n_layers, n_slots, max_len + prefill_chunk, cfg.n_kv_heads,
                     cfg.head_dim)
            if windowed and context_shift in ("auto", False):
                # the ring cache: old context leaves the windowed layers'
                # rings by itself, so no context shift (zllm's choice)
                self.kv = KVCacheSWA.create_swa(cfg, n_slots, max_len, prefill_chunk,
                                                kv_dtype or torch.bfloat16, self.device)
                self.context_shift = False
            elif quant:
                self.kv = KVCacheQ8.create(*shape, device=self.device)
            else:
                self.kv = KVCache.create(*shape, kv_dtype or torch.bfloat16, self.device)
        if self.draft is not None:
            # the draft's own contiguous stripe, bf16 under a q8 cache
            dcfg = self.draft.cfg
            self.dkv = KVCache.create(dcfg.n_layers, n_slots, self.max_len + prefill_chunk,
                                      dcfg.n_kv_heads, dcfg.head_dim,
                                      kv_dtype or torch.bfloat16, self.device)
            self._draft_seen = [0] * n_slots  # history positions fed to the draft

        # per-slot sampling parameters, generators and penalty windows
        self._params = batched.SlotParams(n_slots)
        self._br_mask = torch.from_numpy(
            batched.breaker_mask(model.tokenizer, cfg.vocab_size)).to(self.device)
        self._gens = [torch.Generator(device=self.device) for _ in range(n_slots)]
        for i, g in enumerate(self._gens):
            g.manual_seed(i)
        self._recent = np.full((n_slots, PENALTY_WINDOW), -1, np.int32)
        self._mu = np.full((n_slots,), 10.0, np.float32)  # mirostat-v2 state

        self.slots = [_Slot(idx=i) for i in range(n_slots)]
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self._control: "queue.Queue" = queue.Queue()  # callables run on the engine thread
        self._stop = False
        self._wake = threading.Event()
        self.metrics = {
            "requests_total": 0,
            "tokens_generated_total": 0,
            "tokens_prefilled_total": 0,
            "tokens_prefix_reused_total": 0,
            "decode_steps_total": 0,
            "prefill_steps_total": 0,
            "context_shifts_total": 0,
            "pages_cow_unshared_total": 0,
            "engine_errors_total": 0,
            "spec_drafted_total": 0,
            "spec_accepted_total": 0,
            "lookahead_steps_total": 0,
            "lookahead_accepted_total": 0,
        }
        self.hist_ttft = Histogram()  # time to first token (s)
        self.hist_per_token = Histogram((0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0))
        self.hist_request = Histogram()
        self.thread = threading.Thread(target=self._loop, daemon=True, name="zllm-engine")

    # -- public API ---------------------------------------------------------
    def start(self):
        self.thread.start()

    def stop(self):
        self._stop = True
        self._wake.set()
        self.thread.join(timeout=30)

    def submit(self, req: Request) -> Request:
        if len(req.prompt_tokens) >= self.max_len:
            raise ValueError(f"prompt ({len(req.prompt_tokens)}) exceeds context ({self.max_len})")
        if req.media:
            raise _not_ported("media (multimodal requests)", "4.8")
        self.metrics["requests_total"] += 1
        self.pending.put(req)
        self._wake.set()
        return req

    def run_in_loop(self, fn):
        """Execute fn() on the engine thread between steps; returns its
        result (cache mutations must not race the step)."""
        if not self.thread.is_alive():
            return fn()
        done = threading.Event()
        box = {}

        def wrapper():
            try:
                box["result"] = fn()
            except Exception as e:  # noqa: BLE001 — handed back to the caller
                box["error"] = e
            done.set()

        self._control.put(wrapper)
        self._wake.set()
        if not done.wait(timeout=120):
            raise TimeoutError("engine control task timed out")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def save_slot(self, idx: int, path: str) -> dict:
        """Write slot idx's K/V [0, pos) to a state file."""
        def do():
            s = self.slots[idx]
            state.seq_save_file(path, self.model, self.kv, idx, s.pos)
            return {"id": idx, "n_past": s.pos, "filename": path}

        return self.run_in_loop(do)

    def restore_slot(self, idx: int, path: str, tokens: list[int] | None = None) -> dict:
        """Load a state file into idle slot idx; `tokens` (the ids whose K/V
        the file holds) let the next request with that prefix reuse it."""
        def do():
            s = self.slots[idx]
            if s.state != SlotState.IDLE:
                raise ValueError(f"slot {idx} is busy")
            if self.paged and not self.alloc.exclusively_owned(idx):
                # the restore writes through the slot's table: give it pages
                # no other slot maps (their old contents are gone)
                self.alloc.assign_slot(idx, None, 0)
                self.kv = self.kv.with_table(self.alloc.table)
                s.pos, s.cache_tokens = 0, []
            self.kv, n_past = state.seq_load_file(path, self.model, self.kv, idx)
            s.pos = n_past
            s.cache_tokens = list(tokens or [])[:n_past]
            return {"id": idx, "n_past": n_past}

        return self.run_in_loop(do)

    def erase_slot(self, idx: int) -> dict:
        """Forget idle slot idx's cached prefix."""
        def do():
            s = self.slots[idx]
            if s.state != SlotState.IDLE:
                raise ValueError(f"slot {idx} is busy")
            s.pos = 0
            s.cache_tokens = []
            return {"id": idx}

        return self.run_in_loop(do)

    def metrics_view(self) -> dict:
        return dict(self.metrics)

    def slot_info(self) -> list[dict]:
        return [
            {
                "id": s.idx,
                "state": s.state.name.lower(),
                "n_past": s.pos,
                "n_cached": len(s.cache_tokens),
                "request": s.req.rid if s.req else None,
                "generated": s.generated,
            }
            for s in self.slots
        ]

    # -- engine loop --------------------------------------------------------
    def _admit(self):
        while True:
            idle = [s for s in self.slots if s.state == SlotState.IDLE]
            if not idle:
                return
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                return
            # the idle slot with the longest reusable prefix
            best, best_n = idle[0], 0
            if self.prefix_reuse:
                for s in idle:
                    ncp = _common_prefix(s.cache_tokens, req.prompt_tokens)
                    if ncp > best_n:
                        best, best_n = s, ncp
            src_slot = best
            if self.paged and self.prefix_reuse:
                # full prefix pages can be shared from ANY slot (even a busy
                # one: full pages are immutable), so search all of them
                for s in self.slots:
                    ncp = _common_prefix(s.cache_tokens, req.prompt_tokens)
                    if ncp > best_n:
                        src_slot, best_n = s, ncp
                        if s.state == SlotState.IDLE:
                            best = s
            # keep >= 1 token to prefill so the step yields next-token logits
            n_reuse = min(best_n, len(req.prompt_tokens) - 1)
            if isinstance(self.kv, KVCacheSWA):
                # the ring's writes start at a multiple of the chunk (no wrap
                # inside a run)
                n_reuse -= n_reuse % self.prefill_chunk
            if self.paged:
                n_reuse -= n_reuse % self.alloc.ps  # only FULL pages are shareable
            if n_reuse < 16:  # not worth the bookkeeping below this
                n_reuse = 0
            slot = best
            if self.paged:
                if n_reuse > 0 and src_slot is not slot:
                    self.alloc.assign_slot(slot.idx, src_slot.idx, n_reuse // self.alloc.ps)
                    self.kv = self.kv.with_table(self.alloc.table)
                elif n_reuse == 0:
                    # fresh mapping (drops any retained pages of this slot)
                    self.alloc.assign_slot(slot.idx, None, 0)
                    self.kv = self.kv.with_table(self.alloc.table)
                # n_reuse > 0 and the source is the slot itself: keep its mapping
            if self.draft is not None:
                self._draft_seen[slot.idx] = 0  # full catch-up on the first draft
            self._la.pop(slot.idx, None)  # a fresh Jacobi window a request
            slot.req = req
            slot.state = SlotState.PROMPT
            slot.pos = n_reuse
            slot.cache_tokens = req.prompt_tokens[:n_reuse]
            slot.prompt_left = list(req.prompt_tokens[n_reuse:])
            slot.generated = 0
            req.n_prompt_reused = n_reuse
            self.metrics["tokens_prefix_reused_total"] += n_reuse
            # per-slot sampling params + generator seed + penalty window
            self._params.set_slot(slot.idx, req)
            self._mu[slot.idx] = 2.0 * req.mirostat_tau
            seed = req.seed if req.seed >= 0 else int(time.time_ns() & 0x7FFFFFFF) + slot.idx
            self._gens[slot.idx].manual_seed(seed)
            hist = req.prompt_tokens[-PENALTY_WINDOW:]
            self._recent[slot.idx] = -1
            if hist:
                self._recent[slot.idx, -len(hist):] = hist

    def _finish(self, slot: _Slot, reason: str, error: str = ""):
        req = slot.req
        req.finish_reason = reason
        req.error = error
        req.done = True
        req.t_done = time.time()
        if req.t_first_token:
            self.hist_ttft.observe(req.t_first_token - req.t_submit)
            if len(req.out_tokens) > 1:
                self.hist_per_token.observe(
                    (req.t_done - req.t_first_token) / (len(req.out_tokens) - 1)
                )
        self.hist_request.observe(req.t_done - req.t_submit)
        req.stream_q.put(None)  # sentinel
        slot.state = SlotState.IDLE
        slot.req = None

    def _loop(self):
        # inference mode is thread-local: the engine thread enters it itself
        with torch.inference_mode():
            while not self._stop:
                try:
                    self._step_once()
                except Exception as e:  # noqa: BLE001
                    # a failed step must not kill the engine thread: error
                    # out the in-flight requests, keep serving
                    self.metrics["engine_errors_total"] += 1
                    msg = f"{type(e).__name__}: {e}"
                    for s in self.slots:
                        if s.req is not None:
                            s.cache_tokens = []
                            s.pos = 0
                            self._finish(s, "error", msg)

    def _step_once(self):
        while True:  # control tasks run between steps
            try:
                self._control.get_nowait()()
            except queue.Empty:
                break
        self._admit()
        prompt_slots = [s for s in self.slots if s.state == SlotState.PROMPT]
        gen_slots = [s for s in self.slots if s.state == SlotState.GENERATING]

        if not prompt_slots and not gen_slots:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            return

        if self._la:
            # accepted lookahead tokens not in the cache yet enter it before
            # any step that is not a lookahead step (a prompt mixing in, a
            # context shift) reads or moves the committed region
            pend = [s for s in gen_slots if self._la.get(s.idx, {}).get("extra")]
            if pend and (prompt_slots or any(
                    s.pos + len(self._la[s.idx]["extra"]) + 1 >= self.max_len for s in pend)):
                self._flush_la_extras(pend)

        for s in gen_slots:
            if s.pos + 1 >= self.max_len:
                self._shift_slot(s)
        gen_slots = [s for s in gen_slots if s.state == SlotState.GENERATING]
        if not prompt_slots and not gen_slots:
            return

        if prompt_slots:
            self._mixed_step(prompt_slots, gen_slots)
        elif self.speculative and any(self._can_spec(s) for s in gen_slots):
            self._spec_decode_step(gen_slots)
        elif self.lookahead and any(self._can_la(s) or self._la.get(s.idx, {}).get("extra")
                                    for s in gen_slots):
            self._lookahead_step(gen_slots)
        else:
            self._decode_step(gen_slots)

    def _shift_slot(self, slot: _Slot):
        """Discard the oldest half of the slot's window, keep n_keep."""
        if not self.context_shift:
            self._finish(slot, "length")
            return
        if self.paged and not self.alloc.exclusively_owned(slot.idx):
            # the shift rewrites pages in place: copy-on-write unshare the
            # shared prefix pages first (fresh private pages + page copies)
            try:
                copies = self.alloc.unshare_slot(slot.idx)
            except IndexError:
                self._finish(slot, "length")  # page pool exhausted
                return
            self.kv = self.kv.copy_pages(copies).with_table(self.alloc.table)
            self.metrics["pages_cow_unshared_total"] += len(copies)
        n_keep = slot.req.n_keep if slot.req else 0
        n_discard = max((self.max_len - n_keep) // 2, 1)
        self.kv = shift_context_row(self.kv, self.model.cfg.rope, slot.idx, n_keep, n_discard,
                                    horizon=self.max_len)
        slot.pos -= n_discard
        slot.cache_tokens = slot.cache_tokens[:n_keep] + slot.cache_tokens[n_keep + n_discard:]
        if self.draft is not None:
            # the draft's stripe is not shifted: its slots past n_keep are
            # fed again (zllm's catch-up would find no token to feed and
            # fail the step)
            self._draft_seen[slot.idx] = min(self._draft_seen[slot.idx], n_keep)
        self.metrics["context_shifts_total"] += 1

    def _forward(self, toks: np.ndarray, pos: np.ndarray, logits_for: str, model=None, kv=None,
                 **kw) -> torch.Tensor:
        model = model or self.model
        dev = self.device
        return forward(model.params, model.cfg, torch.from_numpy(toks).to(dev),
                       torch.from_numpy(pos).to(dev), self.kv if kv is None else kv,
                       logits_for=logits_for,
                       **{k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v
                          for k, v in kw.items()})

    def _mixed_step(self, prompt_slots, gen_slots):
        """One [n_slots, chunk] step: every PROMPT slot's next chunk rides
        in its own row, plus one decode token for every generating slot
        (column 0)."""
        toks = np.zeros((self.n_slots, self.prefill_chunk), dtype=np.int32)
        pos = np.full((self.n_slots, self.prefill_chunk), self.max_len, dtype=np.int32)  # trash
        chunks = {}
        for ps in prompt_slots:
            chunk_real = min(self.prefill_chunk, len(ps.prompt_left))
            chunks[ps.idx] = chunk_real
            toks[ps.idx, :chunk_real] = ps.prompt_left[:chunk_real]
            pos[ps.idx, :chunk_real] = np.arange(ps.pos, ps.pos + chunk_real)
            # a prompt run pads with distinct trash positions, a generating
            # row with one: models/llama.py gives a row whose columns 1 and
            # 2 hold one position the decode step's attention kernel, so a
            # prompt's last token gets the same bits whether it rides alone
            # (after a reused prefix) or inside a longer chunk
            pos[ps.idx, chunk_real:] = self.max_len + np.arange(self.prefill_chunk - chunk_real)
        for s in gen_slots:
            toks[s.idx, 0] = s.last_token
            pos[s.idx, 0] = s.pos

        logits = self._forward(toks, pos, "all")
        self.metrics["prefill_steps_total"] += 1
        cols = np.zeros((self.n_slots,), np.int64)
        sample_rows = []
        for ps in prompt_slots:
            chunk_real = chunks[ps.idx]
            ps.cache_tokens.extend(ps.prompt_left[:chunk_real])
            ps.pos += chunk_real
            ps.prompt_left = ps.prompt_left[chunk_real:]
            self.metrics["tokens_prefilled_total"] += chunk_real
            if not ps.prompt_left:
                cols[ps.idx] = chunk_real - 1
                sample_rows.append(ps)
                ps.state = SlotState.GENERATING
        for s in gen_slots:
            s.cache_tokens.append(s.last_token)
            s.pos += 1

        sample_rows.extend(gen_slots)
        if sample_rows:
            self._sample_and_emit(logits, cols, sample_rows)

    # -- speculative decoding (n-gram or draft model) ---------------------
    def _can_spec(self, slot: _Slot) -> bool:
        """Speculation keeps output exact only for greedy, grammar-free
        slots with headroom before the context limit."""
        req = slot.req
        return (req is not None and req.temp <= 0 and req.grammar is None
                and slot.pos + 2 + self.n_draft < self.max_len)

    def _draft_argmax(self, toks: np.ndarray, pos: np.ndarray) -> np.ndarray:
        logits = self._forward(toks, pos, "all", model=self.draft, kv=self.dkv)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _draft_propose_all(self, slots) -> dict[int, list[int]]:
        """Greedy draft-model proposals for every speculating slot.

        Catch-up: the tokens the draft has not fed yet run through its
        forward in prefill_chunk-wide rounds, every lagging slot a chunk a
        round.  Proposal: n_draft - 1 lock-step [n_slots, 1] draft steps.
        Rejected drafts' K/V are overwritten by the next catch-up."""
        out: dict[int, list[int]] = {}
        if not slots:
            return out
        width = self.prefill_chunk
        first: dict[int, int] = {}
        hists = {s.idx: s.cache_tokens + [s.last_token] for s in slots}
        seen = {s.idx: self._draft_seen[s.idx] for s in slots}
        while any(seen[s.idx] < len(hists[s.idx]) for s in slots):
            toks = np.zeros((self.n_slots, width), dtype=np.int32)
            pos = np.full((self.n_slots, width), self.max_len, dtype=np.int32)
            ns = {}
            for s in slots:
                hist, sn = hists[s.idx], seen[s.idx]
                n = min(width, len(hist) - sn)
                if n <= 0:
                    continue
                ns[s.idx] = n
                toks[s.idx, :n] = hist[sn:sn + n]
                pos[s.idx, :n] = np.arange(sn, sn + n)
            preds = self._draft_argmax(toks, pos)
            for s in slots:
                n = ns.get(s.idx, 0)
                if n and seen[s.idx] + n == len(hists[s.idx]):
                    first[s.idx] = int(preds[s.idx, n - 1])
                seen[s.idx] += n
        for s in slots:
            self._draft_seen[s.idx] = len(hists[s.idx])
            out[s.idx] = [first[s.idx]]
        # chain the remaining drafts of every slot in lock-step
        for _ in range(self.n_draft - 1):
            toks = np.zeros((self.n_slots, 1), dtype=np.int32)
            pos = np.full((self.n_slots, 1), self.max_len, dtype=np.int32)
            for s in slots:
                toks[s.idx, 0] = out[s.idx][-1]
                pos[s.idx, 0] = self._draft_seen[s.idx] + len(out[s.idx]) - 1
            preds = self._draft_argmax(toks, pos)
            for s in slots:
                out[s.idx].append(int(preds[s.idx, 0]))
        return out

    def _spec_decode_step(self, gen_slots):
        """[n_slots, 1 + n_draft] verify step: column 0 is the decode token;
        speculating slots carry drafts in columns 1.. whose logits verify
        them in the same forward (`forward(..., verify=True)`: every column
        gets the decode step's attention at its position, so accepted
        output equals plain greedy decode).  Rejected drafts leave K/V past
        pos, overwritten before anything attends them."""
        from ..runtime.speculative import ngram_propose

        t = self.n_draft + 1
        toks = np.zeros((self.n_slots, t), dtype=np.int32)
        pos = np.full((self.n_slots, t), self.max_len, dtype=np.int32)  # trash
        drafts: dict[int, list[int]] = {}
        proposals = (self._draft_propose_all([s for s in gen_slots if self._can_spec(s)])
                     if self.draft is not None else None)
        for s in gen_slots:
            toks[s.idx, 0] = s.last_token
            pos[s.idx, 0] = s.pos
            if self._can_spec(s):
                cap = min(self.n_draft, self.max_len - s.pos - 2)
                if proposals is not None:
                    d = proposals.get(s.idx, [])[:cap]
                else:
                    d = ngram_propose(s.cache_tokens + [s.last_token], cap)[:cap]
                if d:
                    toks[s.idx, 1:1 + len(d)] = d
                    pos[s.idx, 1:1 + len(d)] = np.arange(s.pos + 1, s.pos + 1 + len(d))
                    drafts[s.idx] = d
                    self.metrics["spec_drafted_total"] += len(d)

        logits = self._forward(toks, pos, "all", verify=True)
        self.metrics["decode_steps_total"] += 1
        for s in gen_slots:
            s.cache_tokens.append(s.last_token)
            s.pos += 1

        spec_slots = [s for s in gen_slots if s.idx in drafts]
        plain = [s for s in gen_slots if s.idx not in drafts]
        if spec_slots:
            idx = torch.tensor([s.idx for s in spec_slots], device=self.device)
            rows = torch.argmax(logits[idx], dim=-1).cpu().numpy()  # [ns, t]
            for s, preds in zip(spec_slots, rows):
                d = drafts[s.idx]
                accepted = 0
                for i, di in enumerate(d):
                    if int(preds[i]) != di:
                        break
                    accepted += 1
                self.metrics["spec_accepted_total"] += accepted
                # accepted drafts' K/V are in the cache already
                for i in range(accepted):
                    s.cache_tokens.append(d[i])
                    s.pos += 1
                    self._emit_token(s, d[i])
                    if s.state == SlotState.IDLE:
                        break
                else:
                    self._emit_token(s, int(preds[accepted]))
        if plain:
            self._sample_and_emit(logits, np.zeros((self.n_slots,), np.int64), plain)

    # -- lookahead decoding -------------------------------------------------
    def _la_width(self) -> int:
        return self.la_n + (self.la_w + self.la_g) * (self.la_n - 1)

    def _can_la(self, slot: _Slot) -> bool:
        """Lookahead keeps output exact only for greedy, grammar-free slots;
        the window and grams need the step's width of speculative cache
        slots past the committed region."""
        req = slot.req
        if req is None or req.temp > 0 or req.grammar is not None:
            return False
        return (slot.pos + self._la_width() <= self.kv.max_len
                and slot.pos + self.la_n + 1 < self.max_len)

    def _la_init(self, slot: _Slot) -> dict:
        """A slot's fresh Jacobi state: random window levels from the
        request's seed as zllm draws them, and a gram pool seeded from the
        prompt."""
        lvls = self.la_n - 1
        seed = (slot.req.seed if slot.req and slot.req.seed >= 0 else 0) ^ (slot.idx + 1)
        rng = np.random.default_rng(seed & 0x7FFFFFFF)
        window = rng.integers(1, self.model.cfg.vocab_size,
                              size=(lvls, self.la_w)).astype(np.int64)
        pool: dict[int, list] = {}
        hist = slot.cache_tokens + [slot.last_token]
        for i in range(max(0, len(hist) - lvls)):
            gram = tuple(hist[i + 1:i + 1 + lvls])
            if len(gram) == lvls:
                lst = pool.setdefault(hist[i], [])
                if gram not in lst:
                    lst.insert(0, gram)
                    del lst[self.la_g:]
        la = {"window": window, "pool": pool, "extra": []}
        self._la[slot.idx] = la
        return la

    def _flush_la_extras(self, slots):
        """Put accepted lookahead tokens that were verified against
        speculative slots, not stored in committed ones, into the cache by
        one plain causal forward."""
        width = self.la_n - 1
        toks = np.zeros((self.n_slots, width), dtype=np.int32)
        pos = np.full((self.n_slots, width), self.max_len, dtype=np.int32)  # trash
        ext = {}
        for s in slots:
            v = list(self._la[s.idx]["extra"])
            ext[s.idx] = v
            toks[s.idx, :len(v)] = v
            pos[s.idx, :len(v)] = np.arange(s.pos, s.pos + len(v))
        self._forward(toks, pos, "last")
        for s in slots:
            v = ext[s.idx]
            s.cache_tokens.extend(v)
            s.pos += len(v)
            self._la[s.idx]["extra"] = []

    def _lookahead_step(self, gen_slots):
        """One [n_slots, N + (W + G)(N - 1)] forward: each greedy slot's
        pending tokens (stored at their committed slots), W Jacobi window
        columns a level and G verification grams, kept apart by a block
        mask; the speculative columns' K/V go to the headroom past the
        pending ones and are overwritten by the next step.  The longest
        gram chain matching the greedy argmax is accepted.  Other slots
        ride in their pending columns and sample as usual."""
        n, w, g = self.la_n, self.la_w, self.la_g
        lvls = n - 1
        t = self._la_width()
        S = self.kv.max_len
        ns = self.n_slots
        toks = np.zeros((ns, t), dtype=np.int32)
        pos = np.full((ns, t), S - 1, dtype=np.int32)  # trash for idle rows
        slots_arr = np.full((ns, t), S - 1, dtype=np.int32)
        mask = np.zeros((ns, t, S), dtype=bool)

        la_slots = []
        meta: dict[int, tuple] = {}
        col_w0 = n
        col_v0 = n + lvls * w
        for s in gen_slots:
            la = self._la.get(s.idx)
            spec = self._can_la(s)
            if spec and la is None:
                la = self._la_init(s)
            pending = (list(la["extra"]) if la else []) + [s.last_token]
            m = len(pending)
            p0 = s.pos
            base = p0 + m
            for j in range(n):
                if j < m:
                    toks[s.idx, j] = pending[j]
                    pos[s.idx, j] = slots_arr[s.idx, j] = p0 + j
                    mask[s.idx, j, :p0 + j + 1] = True
                else:  # a pad column parks its K/V in a spec slot, attends itself
                    pos[s.idx, j] = slots_arr[s.idx, j] = base + (j - m)
                    mask[s.idx, j, base + (j - m)] = True
            if not spec:
                meta[s.idx] = (m, pending, [])
                continue
            la_slots.append(s)
            spec0 = base + (n - m)
            window = la["window"]
            for j in range(lvls):
                for i in range(w):
                    c = col_w0 + j * w + i
                    toks[s.idx, c] = window[j, i]
                    pos[s.idx, c] = base + i + j
                    slots_arr[s.idx, c] = spec0 + (c - n)
                    mask[s.idx, c, :base] = True
                    for j2 in range(j):  # its own column at lower levels
                        mask[s.idx, c, spec0 + (col_w0 + j2 * w + i) - n] = True
                    mask[s.idx, c, spec0 + (c - n)] = True
            cands = list(la["pool"].get(pending[-1], []))[:g]
            meta[s.idx] = (m, pending, cands)
            for gi in range(g):
                gram = cands[gi] if gi < len(cands) else (0,) * lvls
                for tt in range(lvls):
                    c = col_v0 + gi * lvls + tt
                    toks[s.idx, c] = gram[tt]
                    pos[s.idx, c] = base + tt
                    slots_arr[s.idx, c] = spec0 + (c - n)
                    mask[s.idx, c, :base] = True
                    for t2 in range(tt):  # its gram's earlier tokens
                        mask[s.idx, c, spec0 + (col_v0 + gi * lvls + t2) - n] = True
                    mask[s.idx, c, spec0 + (c - n)] = True
        mask[~mask.any(-1), S - 1] = True  # a query row with no slot attends one junk slot

        logits = self._forward(toks, pos, "all", mask=mask, kv_positions=slots_arr)
        self.metrics["decode_steps_total"] += 1
        self.metrics["lookahead_steps_total"] += 1

        for s in gen_slots:  # the pending tokens' K/V are in the cache now
            m, pending = meta[s.idx][0], meta[s.idx][1]
            s.cache_tokens.extend(pending)
            s.pos += m
            if self._la.get(s.idx):
                self._la[s.idx]["extra"] = []

        la_set = {s.idx for s in la_slots}
        plain = [s for s in gen_slots if s.idx not in la_set]
        if la_slots:
            idx = torch.tensor([s.idx for s in la_slots], device=self.device)
            args = torch.argmax(logits[idx], dim=-1).cpu().numpy()  # [n la slots, t]
            for s, arg in zip(la_slots, args):
                m, pending, cands = meta[s.idx]
                la = self._la[s.idx]
                x_next = int(arg[m - 1])
                accepted = [x_next]
                best, best_out = 0, []
                for gi, gram in enumerate(cands):
                    cur, outs = x_next, []
                    for tt in range(lvls):
                        if gram[tt] != cur:
                            break
                        cur = int(arg[col_v0 + gi * lvls + tt])
                        outs.append(cur)
                    if len(outs) > best:
                        best, best_out = len(outs), outs
                accepted += best_out
                self.metrics["lookahead_accepted_total"] += best
                # harvest the trajectory grams, then the Jacobi shift
                window = la["window"]
                new_last = arg[col_w0 + (lvls - 1) * w:col_w0 + lvls * w]
                for i in range(w):
                    gram2 = tuple(int(window[j, i]) for j in range(1, lvls)) + (
                        int(new_last[i]),)
                    lst = la["pool"].setdefault(int(window[0, i]), [])
                    if gram2 not in lst:
                        lst.insert(0, gram2)
                        del lst[g:]
                window[:-1] = window[1:]
                window[-1] = new_last
                emitted = []
                for tok in accepted:
                    self._emit_token(s, tok)
                    emitted.append(tok)
                    if s.state == SlotState.IDLE:
                        break
                if s.state != SlotState.IDLE:
                    la["extra"] = emitted[:-1]
        if plain:
            cols = np.zeros((self.n_slots,), np.int64)
            for s in plain:
                cols[s.idx] = meta[s.idx][0] - 1
            self._sample_and_emit(logits, cols, plain)

    def _decode_step(self, gen_slots):
        toks = np.zeros((self.n_slots, 1), dtype=np.int32)
        pos = np.full((self.n_slots, 1), self.max_len, dtype=np.int32)  # trash for idle rows
        for s in gen_slots:
            toks[s.idx, 0] = s.last_token
            pos[s.idx, 0] = s.pos
        logits = self._forward(toks, pos, "last")
        self.metrics["decode_steps_total"] += 1
        for s in gen_slots:
            s.cache_tokens.append(s.last_token)
            s.pos += 1
        self._sample_and_emit(logits, np.zeros((self.n_slots,), np.int64), gen_slots)

    # -- sampling & emission ------------------------------------------------
    def _sample_and_emit(self, logits, cols, slots):
        """Batched chain sampling with the grammar applied inside the chain:
        sample once unconstrained; if a grammar slot drew a disallowed
        token, fold the grammar mask into that slot's raw logits and rerun
        the full chain for it."""
        dev = self.device
        rows = torch.arange(self.n_slots, device=dev)
        picked = logits[rows, torch.from_numpy(cols).to(dev)]  # [n_slots, V]
        args = torch.from_numpy(np.stack(self._params.arrays())).to(dev).unbind(0)
        recent = torch.from_numpy(self._recent).to(dev)
        toks, _, mu1 = batched.sample_batch(picked, self._gens, recent, self._br_mask,
                                            torch.from_numpy(self._mu).to(dev), *args)
        toks_host = toks.cpu().numpy()
        reject = [s for s in slots
                  if s.req.grammar is not None and not s.req.grammar.allowed([int(toks_host[s.idx])])]
        if not reject:
            self._mu = mu1.cpu().numpy().copy()
            for s in slots:
                self._emit_token(s, int(toks_host[s.idx]))
            return

        picked_host = picked.cpu().numpy()
        masked = picked_host.copy()
        for s in reject:
            masked[s.idx] += self._grammar_mask_row(s.req, picked_host[s.idx])
        # resampled rows advance their generator twice, the others once
        states = [g.get_state() for g in self._gens]
        toks2, _, mu2 = batched.sample_batch(torch.from_numpy(masked).to(dev), self._gens, recent,
                                             self._br_mask, mu1, *args)
        toks2_host = toks2.cpu().numpy()
        rej = np.zeros((self.n_slots,), bool)
        for s in reject:
            rej[s.idx] = True
        for i, g in enumerate(self._gens):
            if not rej[i]:
                g.set_state(states[i])
        self._mu = np.where(rej, mu2.cpu().numpy(), mu1.cpu().numpy()).astype(np.float32)
        for s in slots:
            tok = int(toks2_host[s.idx]) if rej[s.idx] else int(toks_host[s.idx])
            self._emit_token(s, tok)

    def _grammar_mask_row(self, req, logits_row: np.ndarray) -> np.ndarray:
        """[V] additive mask (0 allowed / NEG_INF disallowed) from the
        grammar automaton, scanning candidates in descending-logit stages so
        it runs over the few thousand tokens that carry probability mass
        before falling through to the tail."""
        order = np.argsort(-logits_row)
        v = logits_row.shape[0]
        allowed: list[int] = []
        for a, b in ((0, 512), (512, 4096), (4096, v)):
            if a >= v:
                break
            allowed.extend(req.grammar.allowed(order[a:b]))
            if len(allowed) >= 16:
                break
        mask = np.full((v,), NEG_INF, np.float32)
        if allowed:
            mask[allowed] = 0.0
        else:  # dead end: surface as a stop (EOS) rather than crash
            mask[self.model.tokenizer.eos_id if self.model.tokenizer else 0] = 0.0
        return mask

    def _check_stop_strings(self, req: Request) -> bool:
        """Scan the decoded text for any stop string; records the match
        offset so the HTTP layer trims the stop text from the output."""
        if self.model.tokenizer is None:
            return False
        if req._stopdec is None:
            from ..tokenizer import IncrementalDecoder

            req._stopdec = IncrementalDecoder(self.model.tokenizer)
        req._text += req._stopdec.push(req.out_tokens[-1])
        for ss in req.stop_strings:
            i = req._text.find(ss)
            if i >= 0:
                req.stop_trim_chars = i
                return True
        return False

    def _emit_token(self, slot: _Slot, tok: int):
        req = slot.req
        if req.grammar is not None:
            req.grammar.accept_token(tok)
        slot.last_token = tok
        slot.generated += 1
        req.out_tokens.append(tok)
        self._recent[slot.idx] = np.roll(self._recent[slot.idx], -1)
        self._recent[slot.idx, -1] = tok
        if req.t_first_token == 0.0:
            req.t_first_token = time.time()
        self.metrics["tokens_generated_total"] += 1
        req.stream_q.put(tok)

        if tok in req.stop_tokens:
            self._finish(slot, "stop")
        elif req.stop_strings and self._check_stop_strings(req):
            self._finish(slot, "stop")
        elif slot.generated >= req.max_new:
            self._finish(slot, "length")
        elif slot.pos + 1 >= self.max_len and not self.context_shift:
            self._finish(slot, "length")
