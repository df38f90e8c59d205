#!/usr/bin/env python3
"""Smoke test of the zllm_torch port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final result line):
  1. build the twelve CUDA kernels from zllm_torch/csrc (nvcc, in parallel),
     and print the `-Xptxas -v` registers and spill bytes of the tensor-core
     attention loops' instantiations (csrc/attn_mma.cuh; K6's two-pass form
     in csrc/flash_attn.cu) and of the sliced GEMM loop
     (csrc/gemm_slice.cuh) under K3's and K5's decoders, of K1
     (csrc/q4k_matvec.cu), and of the one-launch cluster decode step
     (csrc/decode_cluster.cuh) under K7's, K8's and K9's addressors, with
     cudaOccupancyMaxActiveClusters of each K8 instantiation, and of K4
     (csrc/int8_matvec.cu) and K2 (csrc/attn_decode.cu), and of K12
     (csrc/q4k_matvec_hbm.cu, with its ring's stages a warp and a block's
     shared-memory bytes) and K11 (csrc/w4a8dd_matvec.cu); a spill fails,
     and so does a build that lacks one of their instantiations;
  2. small-model checks: 2-layer llamas in Q4_K, Q4_K_M, Q4_0, Q5_K_M,
     Q3_K_M and IQ4_XS (`python -m zllm_torch.quantize` from an F16 file),
     Q5_0, Q5_1, Q8_0, Q2_K, IQ4_NL and MXFP4, the IQ grid presets
     IQ3_XXS, IQ1_S, IQ1_M, IQ2_XXS, IQ2_XS, IQ2_S and IQ3_S (the
     factory's `ftype=`: random code bytes, wv Q4_K, the head Q5_K; K4 and
     K5 launched, IQ1_M's matvecs on K5), TQ2_0 and TQ1_0 (`python -m
     zllm_torch.quantize`: K4 and K5 in their TQ forms) and BF16 (dense
     weights, K2 and K6 alone), and 2-layer
     OLMo-2 files in Q4_K, Q4_K_M and Q4_1, each generated on the GPU
     (kernels) and on the CPU (their plain versions), logits compared step
     by step, the Q4_0 and Q4_1 ones once more with ZLLM_QMM_DUALDOT=1 (K11
     launched); 2-layer Qwen3 (per-head q/k norms, 4 / 2 heads of 128),
     Qwen2 (q/k/v biases, 6 / 1 heads of 128) and Llama-3 (rope_freqs.weight,
     llama3 rope scaling, a llama-bpe vocab) Q4_K files with byte-level BPE
     vocabs, the same way, K1 and K2 launched; the BPE tokenizer's ids of a
     pinned text for the gpt-2, llama-bpe and qwen2 pretokenizers on this
     host (which may lack `regex`) against the ids the CPU tests hold equal
     to zllm's (`tokenizer_roundtrip`); and the 2-layer Q4_K_M files served by the
     continuous-batching Engine (f32, 2 slots) on the GPU and on the CPU:
     the llama in three KV layouts, f32 paged, f32 contiguous and q8 (int8,
     contiguous), the OLMo-2 one in f32 contiguous and f32 paged, the Q4_0
     and Q5_K_M llamas paged, the Q3_K_M, IQ3_XXS and TQ2_0 llamas paged
     with 4 slots (K5's Q3_K, IQ3_XXS and TQ2_0 forms at the engine's
     decode M = 4), and the Qwen2 one paged and
     q8 (G 6, head_dim 128; a last wave with a non-ASCII chatml prompt, its streamed text printed
     and equal on both sides): three prompts, one across a page, then a re-send
     sharing its first 130 tokens; tokens, reuse and step counters must be
     identical, and each run on the GPU must launch its attention kernels
     and no other (llama: paged K9/K10, contiguous K2/K6, q8 K7 alone;
     OLMo-2: contiguous K8/K6, never K2; paged K9/K10), the contiguous ones
     one K6 a layer and mixed step and one K2 or K8 a layer and step (a
     mixed step's column 0 once more through the decode step's kernel);
  3. main paths, at TinyLlama geometry (all 22 layers, full width, random
     weights from a seed, byte-level tokenizer), loaded in bf16 on the GPU,
     each Generator(max_len=2048).generate on a 300-token prompt (two
     256-token prefill chunks) with 32 greedy tokens, the launch counters
     set to 0 just before and read just after (a chunk, a T > 1 step over
     the contiguous cache, also attends column 0 through the decode step's
     kernel, K2 or K8, and its K6 launches must all take the tensor-core
     form, `mma_launches`), then one decode step's `forward` at the last
     position captured in a CUDA graph and replayed (`step_graph_ms`: the
     device time of the step's real interleaving of kernels and torch ops):
       - Q4_K everywhere: 89 K1 + 22 K2 launches per decode step, 89 K3 +
         22 K6 + 22 K2 per chunk;
       - Q4_K_M (zllm_torch.quantize from an F16 file: attn_v, the first 11
         ffn_down and the head Q6_K): 99 K1 + 34 K4 + 22 K2 per decode step,
         99 K3 + 34 K5 + 22 K6 + 22 K2 per chunk;
     then OLMo-2-0425-1B geometry (16 layers, n_embd 2048, 16/16 heads of
     128, n_ff 8192, vocab 100352; Q4_K everywhere, random weights from a
     seed), the same generate: 65 K1 + 16 K8 per decode step, 65 K3 + 16 K6
     + 16 K8 per chunk, K2 never (phase `main_path`, model olmo2); then that model
     with ZLLM_QMM_HBM=1 fed the same tokens for 8 decode steps: 65 K12 +
     16 K8 a step, K1 never, logits equal to the K1 run's (`olmo2_hbm`);
     then the Q4_0 / Q4_1 slice: TinyLlama geometry in Q4_0 (`python -m
     zllm_torch.quantize` from the F16 file: token_embd Q4_K, every matmul
     Q4_0), the same generate (89 K1 + 22 K2 a step, 89 K3 + 22 K6 + 22
     K2 a chunk), then 8 steps with ZLLM_QMM_DUALDOT=1 (`q4_0_dualdot`: 22
     K11 + 67 K1 + 22 K2 a step, logits within 1e-4 nmse of the K1 run's);
     OLMo-2 geometry in Q4_1 (the factory), the same generate (65 K1 + 16
     K8 a step, 65 K3 + 16 K6 + 16 K8 a chunk), then `olmo2_q4_1_dualdot` (64 K11
     + 1 K1 + 16 K8 a step) and `olmo2_q4_1_hbm` (65 K12 + 16 K8 a step,
     logits equal to the K1 run's); the Qwen slice at full width and depth,
     byte-level BPE vocab of 151936 (pre qwen2), tied bf16 head (a dense
     torch.matmul, as zllm has it): Qwen3-1.7B geometry (28 layers, n_embd
     2048, 16 / 8 heads of 128, n_ff 6144) in Q4_K, 112 K1 + 28 K2 a step
     (K2 with the per-head q/k norms), 112 K3 + 28 K6 + 28 K2 a chunk; and
     Qwen2.5-1.5B geometry (n_embd 1536, 12 / 2 heads of 128, n_ff 8960,
     q/k/v biases) in Q4_K_M by `python -m zllm_torch.quantize` from its F16
     file, 126 K1 + 42 K4 + 28 K2 a step, 126 K3 + 42 K5 + 28 K6 + 28 K2 a
     chunk; each then timed by kernel at its own shapes (`qwen_step`: K1,
     K4, K2 beside SDPA, the head's matmul and its share of `step_graph_ms`,
     K3 and K5 over a chunk, each checked against its plain version); the
     Q5 slice at TinyLlama geometry: Q5_K_M (`python -m zllm_torch.quantize`
     from the F16 file: wq, wk, wo, gate|up, down Q5_K, wv and the head
     Q6_K), 110 K1 + 23 K4 + 22 K2 a step, 110 K3 + 23 K5 + 22 K6 + 22 K2 a
     chunk, and Q5_0 and Q5_1 (the factory: every matmul, the head too),
     89 K1 + 22 K2 a step, 89 K3 + 22 K6 + 22 K2 a chunk, each then 8 steps
     fed the same tokens under ZLLM_QMM_HBM=1 and under ZLLM_QMM_DUALDOT=1
     (`q5_k_m_hbm`, `q5_0_dualdot`, ...): K1 again, no K12 or K11, logits
     equal to the K1 run's; the low-bit slice at TinyLlama geometry:
     Q3_K_M (`python -m zllm_torch.quantize` from the F16 file: wq, wk, wo,
     gate|up, down Q3_K on K4/K5, wv Q5_K on K1/K3, the head Q6_K), 111 K4
     + 22 K1 + 22 K2 a step, 111 K5 + 22 K3 + 22 K6 + 22 K2 a chunk;
     IQ4_XS (the same way: every matmul IQ4_XS but the Q6_K head, so
     wq|wk|wv fuse), 89 K4 + 22 K2 a step, 89 K5 + 22 K6 + 22 K2 a chunk;
     and Q2_K, IQ4_NL and MXFP4 from the factory (every matmul, the head
     too), the same counts as IQ4_XS; the IQ grid slice at TinyLlama
     geometry, the factory's presets (wq, wk, wo, gate|up, down in the
     type, wv Q4_K, the head Q5_K): IQ3_XXS and IQ1_S, 110 K4 + 23 K1 + 22
     K2 a step, 110 K5 + 23 K3 + 22 K6 + 22 K2 a chunk; IQ1_M, a generate
     of IQ_SHORT_TOKENS, 110 K5 (at M = 1) + 23 K1 + 22 K2 a step and no
     K4; IQ2_XXS, IQ2_XS, IQ2_S and IQ3_S, the short generate with
     IQ3_XXS's counts; the ternary slice at TinyLlama geometry by `python
     -m zllm_torch.quantize` from the F16 file (every matmul in the type,
     the head Q6_K, the embedding Q4_K): TQ2_0 the full generate, TQ1_0 the
     short one, IQ4_XS's counts (89 K4 + 22 K2 a step, 89 K5 + 22 K6 + 22
     K2 a chunk); a BF16 file (every matmul and the embedding BF16, dense:
     torch.matmul), the short generate, 22 K2 a step and 22 K6 + 22 K2 a
     chunk and no matmul kernel; the OLMo-2 Q4_K model's generate over a
     contiguous f16 cache (the bf16 path's counts, every K8 and K6 launch in
     its f16 form); and the
     serving path: that Q4_K_M model behind zllm_torch.server's
     ZllmServer with its defaults (4 slots, max_len 2048, paged KV, chunk
     128) on a local port: four concurrent greedy completions, a streaming
     chat, a re-send sharing two pages, then the four bodies one at a time
     (same texts required); per engine step 99 K3 + 34 K5, and 22 K9 per
     decode step or 22 K10 + 22 K9 per mixed prefill step (K9 once more
     for column 0, the generating rows' token), K1/K2/K4/K6/K7 never;
     then the same server and traffic with the q8 KV cache (`kv_dtype="q8"`,
     the contiguous layout): per engine step 99 K3 + 34 K5 + 22 K7 (44 in
     a mixed step, the second 22 for column 0), no other kernel; then
     `serve_contig`, the bf16 contiguous stripe (`kv_layout="contiguous"`):
     per engine step 99 K3 + 34 K5, and 22 K2 a decode step or 22 K6 + 22
     K2 a mixed step (K2 once more for column 0); in all three, every mixed
     step's 22 K10, first 22 K7 or 22 K6 launches must have taken the
     tensor-core loop (the wrapper's `mma_launches`);
  4. each kernel at its main path's shapes against its plain PyTorch
     version on the card (tolerance stated per kernel), timed (device time,
     launches replayed from a CUDA graph) beside the plain version, the
     one-call PyTorch yardstick where there is one, and its bound (bytes
     over 3.35 TB/s or operations over the peak of their type); K4 and K5
     also once each on a full-width Q8_0 weight, K3 and K5 also at the
     engine's decode M = 4 (K3 and K5 timed by weight role in every chunk
     and step), and K3's and K5's rows at M = 4 against the same rows of an
     M = 512 call on every Q4_K and Q6_K weight of the Q4_K_M model and on
     a Q4_0 and a Q4_1 weight, bit for bit (a difference fails); K6 at a
     TinyLlama, an OLMo-2, a Qwen3 and a Qwen2.5 prefill chunk and a
     `serve_contig` mixed step; K9/K10 at
     the serving path's shapes with a
     scrambled page table; K7 at the q8 serving path's decode and mixed
     steps, over int8 and over bf16 K/V; K9 and K7's split form also once
     at S = 8320 with a row at 8000 (65 chunks over the cluster's 8 blocks),
     K9 beside SDPA on its pages gathered outside the timing; K2 at the
     decode step and at a TinyLlama contiguous engine step (B 4, S 2176, a
     trash row), each beside SDPA on the already-inserted cache (q roped
     outside the timing), its CUDA launches per call counted (1); K4's
     outputs on the phase's seeded inputs hashed (`output_digest`, equal on
     two trees when their outputs are bit-equal);
     and their CUDA launches per call counted by torch.profiler (1 each:
     one thread-block cluster); K8 at the OLMo-2 decode step and
     at a TinyLlama-geometry contiguous engine step (G = 8, a trash row),
     once each at S = 2000 and S = 8320 (a trash row), its launches per
     call counted the same way (1), and `step_graph` beside the sum of the
     step's kernel times (TinyLlama Q4_K: K1 + K2; Q4_K_M and Q5_K_M: K1 +
     K4 + K2; Q5_0, Q5_1: K1 + K2; OLMo-2: K1 + K8; Qwen3 and Qwen2.5: K1
     (+ K4) + K2 + the head's matmul); K1 by weight role;
     K12 over the OLMo-2 step's 65 and the TinyLlama Q4_K step's 89
     matvecs, beside K1 on the same calls; K1, K3 and K12 in their Q4_0 and
     Q4_1 forms at the Q4_0 TinyLlama and Q4_1 OLMo-2 steps and chunks; K11
     over the Q4_0 step's 22 wo matvecs and the Q4_1 step's 64 fuse-"q"
     ones, beside K1 on the same calls; K12's and K11's CUDA launches per
     call counted by torch.profiler (1 each); K1 and K3 in their Q5 forms
     over the Q5_K_M, Q5_0 and Q5_1 steps and chunks (by weight role; K3
     also at M = 4 on the Q5_K_M weights, and their rows at M = 4 against
     an M = 512 call's, bit for bit), each against its plain version (nmse
     <= 1e-6), beside `torch.matmul` on the bf16-dequantized weights; K4
     and K5 in their Q2_K, Q3_K, IQ4_NL, IQ4_XS and MXFP4 forms over the
     low-bit steps and chunks by weight role (`kernel_lowbit`; K5 also at M
     = 4 on the Q3_K_M weights, and its rows at M = 4 against an M = 512
     call's on every Q3_K and IQ4_XS weight, bit for bit), bounded by each
     weight's GGUF bytes (the layout's bytes a weight beside them); K4 and
     K5 in the IQ grid forms the same way over the seven IQ steps and
     chunks (`kernel_iq`: IQ1_M's step on K5 at M = 1, K5 at M = 4 on the
     IQ3_XXS weights, K1 on each step's wv and head; rows at M = 4 against
     an M = 512 call's on every IQ3_XXS, IQ1_S and IQ1_M weight and a
     gate|up of the other four); K4 and K5 in their TQ forms over the TQ2_0
     and TQ1_0 steps and chunks the same way (`kernel_tq`: the Q6_K head on
     K4 beside them, K5 at M = 4 on the TQ2_0 weights, rows at M = 4 against
     an M = 512 call's on every TQ weight); and
     digests of K1's and K3's outputs in the Q4_K, Q4_0, Q4_1, Q5_0, Q5_1
     and Q5_K forms and of K4's and K5's in the Q6_K, Q8_0, Q2_K, Q3_K,
     IQ4_NL, IQ4_XS and MXFP4 forms on
     seeded random GGUF bytes, and of the attention kernels' f32 and bf16
     forms (K2, K6, K8, K9, K10; caches and pools after the insert too) and
     K7's int8 and bf16 ones, then of the attention kernels' f16 forms, and
     of K4's and K5's IQ grid and TQ forms, each on a stream of its own
     ("absent" in a tree without the form) (`form_digests`; `python3
     chip_smoke.py --digest` prints them alone, so that two trees' can be
     compared);
  5. the f16 KV cache (llama.cpp's default -ctk/-ctv f16): the build of the
     f16 forms of K10 (attn_mma.cuh), K6, K9 and K8 (decode_cluster.cuh)
     and K2 (`build_f16`: registers and spills, 24 instantiations); 2-layer
     llama, Qwen3 and OLMo-2 files through Generator(kv_dtype=float16)
     GPU-vs-CPU (OLMo-2: K8 and K6 in their f16 forms); 4-slot paged and
     contiguous f16 engines and a 4-slot OLMo-2 contiguous f16 engine
     GPU-vs-CPU (`f16_paged`, `f16_contiguous`, `olmo2_contiguous_f16`);
     K8's f16 form against its plain version at OLMo-2's heads with f32 and
     bf16 q, a trash row and f16 subnormal probabilities
     (`olmo2_contiguous_f16`); the
     TinyLlama Q4_K_M generate over an f16 cache (`main_path`, kv_dtype
     float16: the bf16 path's counts, every K2 and K6 launch in its f16
     form, `f16_launches`); `serve_f16` and `serve_contig_f16`, the same
     server over f16 pages (K9/K10) and an f16 stripe (K2/K6);
     `serve_contig_f16_olmo2`, the same server and traffic over the
     full-width OLMo-2 Q4_K model on an f16 stripe (4 slots, S 2176: per
     engine step 65 K3, and 16 K8 a decode step or 16 K6 + 16 K8 a mixed
     step, every K8 and K6 launch in its f16 form); `serve_tq2_0`, the
     TinyLlama TQ2_0 model behind the default server (paged: per engine
     step 89 K5, K5's TQ form at M = 4 and its Q6_K form for the head, and
     K9/K10 as in `serve`); and
     `kernel_f16`: each f16 form against its plain version (f32 and bf16 q,
     nmse <= 1e-6), timed beside its bound, plain version and SDPA on the
     same f16 K/V, at the bf16 rows' shapes (K8 at the OLMo-2 step, with
     its bf16 form in the same call, and at a TinyLlama engine step), and
     K9/K10 at Qwen2.5's G 6, d 128 in bf16 and f16;
  6. the importance matrix (`imatrix`): `zllm_torch.imatrix`'s collection
     over the TinyLlama-geometry Q8_0 file (full width and depth, bf16) on
     a corpus of 8 chunks of 512 tokens from its byte-level vocab, two
     chunks a forward with no cache: 89 K5 (Q8_0, M = 1024) + 22 K6 a
     forward and nothing else, the counters set to 0 just before and read
     just after (K6 in its f32 tile form: with no cache K/V stay f32); the
     first forward's chunks once more through K5's and K6's plain versions
     on the card (each tensor's sums within IMATRIX_PLAIN_NMSE);
     `kernel_imatrix`: K5 over a forward's 89 GEMMs by weight role and K6
     over its 22 attentions (the forward's own calls, recorded) against
     their plain versions, timed beside bound and library; `quantize_imatrix`: the
     TinyLlama F16 file to IQ2_XXS by `zllm_torch.quantize`'s
     quantize_file with that imatrix, the grid fit on the card (seconds),
     each of the seven IQ types' encode of blk.0.ffn_gate (5632 x 2048) on
     the card (seconds, weighted error against the unweighted encode's,
     its first IQ_FIT_ROWS rows against the CPU fit's: the share of equal
     256-blocks, at least IQ_FIT_MIN_SHARE), then the written file's
     8-token generate (`main_path`: 110 K4 + 23 K1 + 22 K2 a step, 110 K5
     + 23 K3 + 22 K6 + 22 K2 a chunk, as the factory's IQ2_XXS file);
  7. slot state, the API surface, the router, the prompt cache and the
     engine's switches over the TinyLlama Q4_K_M model, every launch of
     each window held to its engines' step counters: `slots_paged_bf16`,
     `slots_contiguous_bf16`, `slots_paged_f16` and `slots_q8` (a 641-id
     prompt P, greedy, 32 tokens gives R in slot 0; /slots save, erase,
     unrelated requests until every saved position of slot 0 is rewritten,
     restore into slot 1 with the file's tokens; P again must reuse the
     restored 640 ids and, bf16 and f16, give R; a save of the restored
     slot holds the first file's k/v arrays bit for bit; q8: the card's
     requantized codes and scales equal a CPU restore of the file, bit for
     bit); `messages_infill_tools` (/v1/messages greedy text equal to
     /v1/chat/completions content, count_tokens equal to prompt_tokens,
     /infill over grafted FIM ids, a forced tool call streamed and not
     streamed giving one parsed call valid under its schema); `router`
     (`server/router.py` over the TinyLlama Q4_K_M and OLMo-2 Q4_K files,
     models_max 1, requests alternating so each loads the other out:
     torch.cuda.memory_allocated after every eviction at most its value
     before the first load plus the resident model's parameter and KV
     bytes, within ROUTER_SLACK; replicas 2 alternating); `prompt_cache`
     (`python -m zllm_torch.cli -f P --prompt-cache F` twice, the second
     reusing all of P but its last token and printing the first's text);
     `switches` (Engine(prefix_reuse=False) reusing nothing under
     shared-prefix traffic; Engine(context_shift=False) finishing at
     max_len with "length", no shift);
  8. speculative decoding, lookahead and the whole-cache context shift
     over the TinyLlama Q4_K_M model (`python3 chip_smoke.py --spec` runs
     this group alone): a 4-slot contiguous bf16 engine (chunk 128,
     max_len 1024, S 1152) serves four greedy requests with repetitive
     prompts and a sampled one riding along, 48 tokens each: `spec_plain`
     (the plain engine, each greedy token's logits row kept), `spec_ngram`
     (n-gram speculation, n_draft 6: a verify step of 7 columns, K3/K5 at
     M = 28 and K2 once a column a layer), `spec_draft_self` (the model
     drafting for itself; each rejected draft's position and the plain
     logits' top-2 gap) and `spec_draft_small` (a 2-layer Q4_K draft of
     the same width and vocab from the factory): the greedy tokens must
     equal the plain engine's; `lookahead` (la_w 4, la_n 3, la_g 4: 19
     columns, K3/K5 at M = 76, the masked attention plain PyTorch): each
     greedy request's first divergence from the plain tokens, if any, with
     the plain row's top-2 gap and the masked column's max abs logit
     difference, a gap above 4x that difference failing; every window's
     launches held to the step counters and the wrapped step kinds (verify
     steps, lookahead steps, flushes, draft forwards); `spec_kernels`: K3
     and K5 at M = 28 and 76 against their plain versions and their rows
     against an M = 4 call's, K6 with 7 query rows a slot over S = 1152, a
     verify step's column logits against the decode steps' bit for bit,
     the verify and decode steps' graph times and K2's 154 against 22
     launches, `shift_context` on the card against the CPU's, and
     SpeculativeDecoder and lookahead_generate at B = 1 against the
     Generator (printed);
  9. the Gemma text families (`python3 chip_smoke.py --gemma` runs this
     group alone), head_dim 256: `gemma_2layer` (2 layers at Gemma-2's and
     Gemma-3's full widths, Q4_K, the card against the CPU's plain
     forward from a child, `--gemma-cpu NAME`, started after the build;
     prompts past the window, Gemma-2's set to 512), `main_path`
     Gemma-2-2B Q4_K_M cut to 8 of its 26 layers (a 4200-token prompt past
     its 4096 window, 8 K2 a step and 8 K6 a chunk) and Gemma-3-4B cut to 12
     layers (a 1100-token prompt past its 1024 window), `serve_ring_gemma3`
     (the Gemma-3 model behind ZllmServer at max_len 4096: the ring cache,
     K2/K6 in its 2 full layers only, a 1501-id prompt besides),
     `serve_gemma_2b` (Gemma-2B paged: K9/K10 at d 256, G 8), and
     `kernel_gemma`: K2, K6, K9 and K10 in their d 256 forms at those
     paths' shapes against their plain versions and SDPA, one line each
     in the `kernels` line;
 10. mixture-of-experts models and K7 at head_dim 256 (`python3
     chip_smoke.py --moe` runs this group alone): `main_path` Qwen3-30B-A3B
     Q4_K_M at full width cut to 8 of 48 layers (the 300-token prompt in
     chunks, 31 decode steps; each layer's expert K3/K5 launches twice the
     experts it picked, from the recorded routing; the decode step
     profiled eagerly and its per-layer host read of the picks timed
     apart: no CUDA graph, which cannot hold that read), `serve_qwen3_30b_a3b`
     (paged bf16, 4 slots, concurrent texts equal sequential),
     `kernel_moe`: K3 and K5 over one decode step's and one chunk's
     recorded expert calls against their plain versions, torch.matmul on
     the dequantized experts and their bound; `serve_q8_gemma_2b` (Gemma-2B,
     group 9's file, on the q8 cache: 18 K7 at d 256 a decode step, 36 a
     mixed one) and K7's d 256 forms (int8 and bf16 K/V) at its shapes;
     `moe_2layer`: Mixtral-8x7B and Qwen1.5-MoE-A2.7B at full width, 2
     layers (Qwen1.5's 1408-wide down stacks F16: the dense-stack path),
     the card against the CPU's plain forward from a child (`--moe-cpu
     NAME`), each token whose picks differ reported with its k-th to
     (k+1)-th probability gap;
 11. the layer-norm families (`python3 chip_smoke.py --layernorm` runs
     this group alone; the factory's Q4_K_M preset): `main_path` Pythia-1.4B
     at full depth (LayerNorms with biases, a parallel residual, exact-gelu
     MLP, neox rope over 32 of 128 dims; a 500-token prompt in two chunks,
     31 decode steps: 4 matvecs a layer + the head on K1/K4 unfused, 24 K2
     a step and a chunk, 24 K6 a chunk), `serve_starcoder2_3b` (StarCoder2-3B
     cut to 8 of 30 layers behind the paged server: K9/K10 at G 12, d 128,
     concurrent texts equal sequential), `ln_2layer` (Pythia-1.4B,
     StableLM-2-1.6B: neox rope over 16 of 64 dims, and StarCoder2-3B at
     full width, 2 layers, Q4_K, the card against the CPU's plain forward
     from a child, `--ln-cpu NAME`: nmse <= 1e-3 and the same greedy token
     at every step, up to the tiled head's ties), `starcoder2_q8` (a
     2-layer StarCoder2 file, 24 / 2 heads of 128, on the q8 cache: the
     engine against the CPU's, K7 at G 12), and `kernel_layernorm`: K2
     with partial neox rope at Pythia's and StableLM-2's shapes and at G
     12, K6 over a Pythia chunk, K9, K10 and K7 at StarCoder2's G 12, each
     against its plain version, SDPA and its bound, and the Pythia step's
     K1/K4 matvecs and a chunk's K3/K5 GEMMs beside their bounds and
     `torch.matmul`; the attention forms' outputs hashed (`form_digests`'
     "layernorm");
 12. gpt-oss (`python3 chip_smoke.py --gpt-oss` runs this group alone):
     `main_path` gpt-oss-20b at full width cut to 4 of its 24 layers (two
     windowed at 128, two full), MXFP4 experts and Q8_0 elsewhere as
     llama.cpp ships it, so every matmul (K 2880) takes zllm's dequantizing
     `torch.matmul` route and no matmul kernel runs; a 300-token prompt past
     the window in chunks, 31 greedy decode steps: 4 K2 a step and a chunk,
     4 K6 a chunk, every one in its sinks form, from the recorded routing;
     `q8_path_gpt_oss` (`forward` over the q8 cache: K7 with sinks, a chunk
     twice a layer, a step once); `serve_ring_chat_gpt_oss` (the ring server,
     4 slots, concurrent /v1/chat/completions whose prompts wrap the
     256-slot ring: texts equal the sequential ones, K2/K6 with sinks in
     the two full layers alone); `gpt_oss_2layer` (2 layers at full width
     against the CPU's plain forward from a child, `--moe-cpu
     gpt_oss_2layer`: nmse <= 1e-3, greedy picks under LN_TIE_GAP, the
     routing's launch formula); and `kernel_gpt_oss`: K2's sinks form at
     the decode step's shapes, K6 with sinks over a chunk (windows 128 and
     0) and K7 with sinks over int8 K/V, each against its plain version,
     SDPA without the sink and its bound; the sinks forms' outputs hashed
     (`form_digests`' "gpt_oss").

The main paths' requantized files (TinyLlama Q4_K_M, Q4_0, Q5_K_M,
Q3_K_M, IQ4_XS, TQ2_0, TQ1_0 and BF16, Qwen2.5 Q4_K_M) and the TinyLlama Q5_0, Q5_1, Q2_K,
IQ4_NL, MXFP4, Q8_0 and IQ grid factory files are made by child processes
(`chip_smoke.py --make-gguf NAME FTYPE...`, niced), the first three
started before the build, the rest and the Gemma files (the factory's
Q4_K_M preset) after it, so the numpy quantizer's minutes run beside the
card's phases.  Each main path also prints
its decode step run eagerly, by CUDA kernel name and summed by kind
(the port's, PyTorch's own, cuBLAS's; `step_profile`, torch.profiler).
A BF16 step hands K2 a bf16 q: `kernel` K2's `bf16_q` times that form at
the main path's shapes for its `step_graph` row.

Prints one JSON line per phase result (with the run's seconds so far,
`elapsed_s`), then the `kernels` line, then the
card's name and power limit from nvidia-smi, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Built kernels and the GGUF files are cached under .cache/ in the checkout.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
CACHE = REPO / ".cache" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks
# GGUF bytes per weight: a super-block holds 256 weights in 84 bytes in
# Q2_K, 110 in Q3_K, 136 in IQ4_XS, 144 in Q4_K, 176 in Q5_K and 210 in
# Q6_K; a block of 32 weights is 34 bytes in Q8_0, 18 in Q4_0 and IQ4_NL,
# 17 in MXFP4, 20 in Q4_1, 22 in Q5_0 and 24 in Q5_1; the IQ grid formats'
# super-blocks are 66 bytes in IQ2_XXS, 74 in IQ2_XS, 82 in IQ2_S, 98 in
# IQ3_XXS, 110 in IQ3_S, 50 in IQ1_S and 56 in IQ1_M; the ternary ones 54
# in TQ1_0 and 66 in TQ2_0; a BF16 weight is two bytes
GGUF_BYTES_PER_WEIGHT = {"Q2_K": 84 / 256, "Q3_K": 110 / 256, "IQ4_XS": 136 / 256,
                         "Q4_K": 144 / 256, "Q5_K": 176 / 256, "Q6_K": 210 / 256,
                         "Q8_0": 34 / 32, "Q4_0": 18 / 32, "IQ4_NL": 18 / 32, "MXFP4": 17 / 32,
                         "Q4_1": 20 / 32, "Q5_0": 22 / 32, "Q5_1": 24 / 32,
                         "IQ2_XXS": 66 / 256, "IQ2_XS": 74 / 256, "IQ2_S": 82 / 256,
                         "IQ3_XXS": 98 / 256, "IQ3_S": 110 / 256, "IQ1_S": 50 / 256,
                         "IQ1_M": 56 / 256, "TQ1_0": 54 / 256, "TQ2_0": 66 / 256,
                         "BF16": 2.0}

PROMPT_TOKENS = 300
NEW_TOKENS = 32
MAX_LEN = 2048
CHUNK = 256
SMALL = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512, vocab_size=512)
SMALL_OLMO2 = dict(SMALL, arch="olmo2", n_kv_heads=4, norm_eps=1e-6, rope_base=500000.0)
# the Qwen slice's 2-layer files: a byte-level BPE vocab of 4096 (3000
# merges); qwen3 per-head q/k norms (4 / 2 heads of 128), qwen2 q/k/v
# biases (6 / 1 heads of 128: G 6), both tied; a Llama-3 file with
# rope_freqs.weight, llama3 rope scaling and a llama-bpe vocab
SMALL_BPE = dict(SMALL, vocab_size=4096, with_tokenizer=True, tokenizer="bpe", pre="qwen2")
SMALL_QWEN3 = dict(SMALL_BPE, arch="qwen3", head_dim=128, tied=True, norm_eps=1e-6,
                   rope_base=1e6)
SMALL_QWEN2 = dict(SMALL_BPE, arch="qwen2", n_heads=6, n_kv_heads=1, head_dim=128, tied=True,
                   norm_eps=1e-6, rope_base=1e6)
SMALL_LLAMA3 = dict(SMALL_BPE, rope_freqs=True, pre="llama-bpe", rope_base=500000.0)
# group 11's 2-layer StarCoder2 file for the q8 engine: 24 / 2 heads of 128
# (G 12), LayerNorms, biases everywhere, the tanh-gelu MLP
SMALL_STARCODER2 = dict(SMALL, arch="starcoder2", n_heads=24, n_kv_heads=2, head_dim=128)
SMALL_SHAPES = {"small": SMALL, "small_olmo2": SMALL_OLMO2, "small_qwen3": SMALL_QWEN3,
                "small_qwen2": SMALL_QWEN2, "small_llama3": SMALL_LLAMA3,
                "small_starcoder2": SMALL_STARCODER2}
SWITCH_STEPS = 8  # decode steps of the phases under ZLLM_QMM_HBM / ZLLM_QMM_DUALDOT
# the low-bit slice's files: Q3_K_M and IQ4_XS requantized, the others from
# the factory (every matmul in the type)
LOWBIT_FTYPES = ("Q3_K_M", "IQ4_XS", "Q2_K", "IQ4_NL", "MXFP4")
# the IQ grid slice's files: the factory's `ftype=` presets (random code
# bytes in the IQ tensors; wv Q4_K, the head Q5_K); the first two run the
# full generate, the others a short one (IQ_SHORT_TOKENS)
IQ_FTYPES = ("IQ3_XXS", "IQ1_S", "IQ1_M", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_S")
IQ_SHORT_TOKENS = 8
# the ternary slice's files, by `python -m zllm_torch.quantize` (the head
# Q6_K, the embedding Q4_K): TQ2_0 the full generate, TQ1_0 a short one
TQ_FTYPES = ("TQ2_0", "TQ1_0")
# group 9, the Gemma text families: Gemma-2-2B cut to GEMMA2_LAYERS of its
# 26 layers with a prompt past its 4096 window, Gemma-3-4B cut to 12 of its 34 layers (two full
# layers, 5 and 11) past its 1024 window and then on the ring at max_len
# 4096, Gemma-2B behind the server (paged: K9/K10 at d 256); the files are
# the factory's Q4_K_M preset, made by children while the kernels build
GEMMA_MODELS = ("gemma2_2b", "gemma3_4b", "gemma_2b")
GEMMA3_LAYERS = 12
GEMMA2_PROMPT, GEMMA2_MAX_LEN = 4200, 4352
# Gemma-2-2B's 26 layers cut to 8 (4 windowed, 4 full), so that group 12
# fits the smoke's time limit
GEMMA2_LAYERS = 8
GEMMA3_PROMPT, GEMMA3_MAX_LEN, GEMMA3_SERVE_MAX_LEN = 1100, 2048, 4096
GEMMA3_LONG_BYTES = 1500  # the ring phase's prompt past the window (one id a byte)
# the 2-layer GPU-vs-CPU checks at full width: Gemma-2's window set to 512
# (its 4096 would take the CPU's plain forward minutes), Gemma-3's real 1024
GEMMA2_CHECK_WINDOW = 512
GEMMA_CHECK_STEPS = 8
# group 10: Qwen3-30B-A3B's 48 layers cut to MOE_LAYERS; the 2-layer checks'
# prompt (one chunk) and teacher-forced decode steps; a token whose picks
# differ between the card and the CPU passes only below MOE_TIE_GAP between
# the CPU's k-th and (k+1)-th router probabilities
MOE_MAIN = "qwen3_30b_a3b"
MOE_LAYERS = 8
MOE_CHECKS = ("mixtral_2layer", "qwen15_moe_2layer")
MOE_CHECK_PROMPT, MOE_CHECK_STEPS = 64, 6
MOE_TIE_GAP = 1e-2
# group 11, the layer-norm families: Pythia-1.4B at full depth (a
# LN_PROMPT-token prompt in two chunks), StarCoder2-3B cut to
# LN_SERVE_LAYERS of its 30 layers behind the paged server, and 2-layer
# full-width Pythia, StableLM-2 and StarCoder2 checks against the CPU (a
# LN_CHECK_PROMPT-token prompt, GEMMA_CHECK_STEPS greedy steps); the files
# are the factory's Q4_K_M preset (Q4_K for the checks), made by children
LN_MAIN, LN_PROMPT = "pythia_1_4b", 500
LN_SERVE, LN_SERVE_LAYERS = "starcoder2_3b", 8
LN_CHECKS = ("pythia_2layer", "stablelm2_2layer", "starcoder2_2layer")
LN_CHECK_PROMPT = 64
# a 2-layer check's card argmax other than the CPU's passes only where the
# CPU scores the two picks less than LN_TIE_GAP apart: twice the largest
# rms |card - CPU| logit difference of these checks' steps on an H100
# (0.0145, StarCoder2-3B's; PERF.md, group 11), rounded up to one digit;
# a tiled head's exact row copies score 0 apart
LN_TIE_GAP = 3e-2
# group 12, gpt-oss: gpt-oss-20b at full width cut to OSS_LAYERS of its 24
# layers (layers 0 and 2 windowed at 128, 1 and 3 full), its files as
# llama.cpp ships it (MXFP4 experts, Q8_0 elsewhere: K 2880, so every
# matmul takes zllm's dequantizing route, no kernel); the ring server with
# OSS_SLOTS slots and chat prompts of OSS_CHAT_TOKENS ids, past its ring of
# 256 slots; a 2-layer full-width check against the CPU over a prompt past
# the window (OSS_CHECK_PROMPT); K2's, K6's and K7's sinks forms at its
# shapes
OSS_MAIN, OSS_LAYERS, OSS_FTYPE = "gpt_oss_20b", 4, "Q8_0"
OSS_CHECK, OSS_CHECK_PROMPT = "gpt_oss_2layer", 136
OSS_SLOTS, OSS_CHAT_TOKENS, OSS_CHAT_NEW = 4, (420, 300, 270, 60), 24
# the 2-layer MoE checks' files and prompts where not Q4_K_M and
# MOE_CHECK_PROMPT
CHECK_FTYPES = {OSS_CHECK: OSS_FTYPE}
CHECK_PROMPTS = {OSS_CHECK: OSS_CHECK_PROMPT}
SERVE_PROMPT_BYTES = (300, 200, 129, 40)
SERVE_NEW_TOKENS = 32
ENGINE_COUNTERS = ("tokens_generated_total", "tokens_prefilled_total",
                   "tokens_prefix_reused_total", "decode_steps_total", "prefill_steps_total",
                   "context_shifts_total", "pages_cow_unshared_total", "engine_errors_total")


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def emit(obj: dict):
    """Print a result line; a phase's line gets the run's seconds so far."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - T_START, 1))
    print(json.dumps(obj), flush=True)


def nmse(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean() / ((b ** 2).mean() + 1e-30))


def cuda_ms(fn, reps: int) -> float:
    """Device time of fn() in ms: fn's launches are captured once in a CUDA
    graph and the graph is replayed `reps` times between two events, so the
    host's launch overhead does not open gaps on the device."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def ptxas_entries(reports: dict, needle: str) -> list[dict]:
    """The `-Xptxas -v` report of each kernel entry whose name holds
    `needle`: its (demangled) name, registers, stack frame, spill stores
    and loads."""
    import re

    out, cur = [], None
    for log in reports.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = dict(name=m.group(1), registers=None, stack_bytes=0, spill_stores=0,
                           spill_loads=0)
                if needle in cur["name"]:
                    out.append(cur)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", line)
            if m and cur is not None:
                cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(e["name"] for e in out),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(out):
            for e, nm in zip(out, names):
                e["name"] = nm.replace("zt_mma::attn_mma_kernel", "attn_mma_kernel")
    except OSError:
        pass
    return out


def cuda_launches(fn) -> int | None:
    """The CUDA kernels one call of fn() launches, counted by torch.profiler
    over a second call (the first builds and sets attributes); None where
    the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
    except RuntimeError as err:  # the profiler, not the kernel: fn() ran above
        print(f"chip_smoke: torch.profiler unavailable: {err}", file=sys.stderr, flush=True)
        return None
    n = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset")))
    return n or None


# step_profile's kinds of CUDA kernel by name: PyTorch's own (elementwise,
# reductions, copies), cuBLAS's products; every other one is the port's
TORCH_KERNELS = ("at::", "elementwise_kernel_with_index")
LIBRARY_KERNELS = ("nvjet", "cublas", "cutlass", "sm90_xmma", "sm80_xmma", "ampere_")


def step_profile(torch, fn, top: int = 10) -> dict:
    """One eager call of fn() by CUDA kernel (torch.profiler over a second
    call): the kernels' count and summed device ms, the same by kind
    (`torch`, `library`, `port`: TORCH_KERNELS, LIBRARY_KERNELS), and the
    `top` kernel names by device time, each with its count and ms; {} where
    the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
    except RuntimeError as err:
        print(f"chip_smoke: torch.profiler unavailable: {err}", file=sys.stderr, flush=True)
        return {}
    rows: dict[str, list] = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = (e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
                .split("<")[0].split("(")[0])
        row = rows.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.elapsed_us() / 1e3
    if not rows:
        return {}
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][1])
    kinds: dict[str, list] = {}
    for name, (c, ms) in rows.items():
        kind = ("torch" if name.startswith(TORCH_KERNELS) else
                "library" if name.startswith(LIBRARY_KERNELS) else "port")
        row = kinds.setdefault(kind, [0, 0.0])
        row[0] += c
        row[1] += ms
    return {"kernels": sum(r[0] for r in rows.values()),
            "device_ms": sum(r[1] for r in rows.values()),
            "by_kind": {k: dict(count=c, ms=ms) for k, (c, ms) in sorted(kinds.items())},
            "top": [dict(name=n, count=c, ms=ms) for n, (c, ms) in ranked[:top]]}


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gguf_bytes(w, bpw: float | None) -> float:
    """The GGUF bytes a weight of `w` takes: `bpw`, or by w's format when
    None (a step whose weights are in more than one format)."""
    return GGUF_BYTES_PER_WEIGHT[w.fmt.name] if bpw is None else bpw


def matvec_phase(torch, fn, plain, calls, n_real, bpw: float | None, eps: float, check=(),
                 groups=None) -> dict:
    """One decode step's matvecs `calls` [(x, w, fuse, aux)] through the
    kernel wrapper `fn`: device ms (and ms per group of call indices), the
    bound (`gguf_bytes(w, bpw)` a weight over each weight's `n_real(w)`
    columns, activations and outputs), and for `check` indices given:
    agreement with `plain` there, the plain version's ms and the cuBLAS bf16
    matmul on the dequantized weights (`library_ms`)."""
    def run(f, sub):
        for x, w, fuse, aux in sub:
            f(x, w, fuse, aux, eps)

    nbytes = sum(w.shape[0] * n_real(w) * gguf_bytes(w, bpw) + x.numel() * x.element_size()
                 + 4 * n_real(w) + (4 * w.shape[0] if fuse == "norm" else 0)
                 for x, w, fuse, _ in calls)
    ops = sum(2 * w.shape[0] * n_real(w) for _, w, _, _ in calls)
    bms, bby = bound_ms(nbytes, ops, "int8")
    out = dict(ms=cuda_ms(lambda: run(fn, calls), 20), bound_ms=bms, bound_by=bby)
    if groups:
        out["ms_by_group"] = {name: cuda_ms(lambda idx=idx: run(fn, [calls[i] for i in idx]), 20)
                              for name, idx in groups.items()}
    if check:
        errs, maxabs = [], 0.0
        for x, w, fuse, aux in (calls[i] for i in check):
            a, b = fn(x, w, fuse, aux, eps), plain(x, w, fuse, aux, eps)
            errs.append(nmse(a, b))
            maxabs = max(maxabs, float((a - b).abs().max()))
        dense = [w.dequant(torch.bfloat16) for _, w, _, _ in calls]
        xb = {id(x): x.to(torch.bfloat16) for x, _, _, _ in calls}

        def lib():
            for (x, _, _, _), wd in zip(calls, dense):
                torch.matmul(xb[id(x)][:, : wd.shape[0]], wd)

        out.update(nmse=max(errs), max_abs_err=maxabs,
                   plain_ms=cuda_ms(lambda: run(plain, calls), 2), library_ms=cuda_ms(lib, 20))
    return out


def gemm_phase(torch, fn, plain, calls, n_real, bpw: float | None, check=(),
               groups=None) -> dict:
    """One prefill chunk's GEMMs `calls` [(x, w)], as matvec_phase; the
    bound is the larger of the bytes and 2*M*K*N bf16 operations."""
    def run(f, sub):
        for x, w in sub:
            f(x, w)

    m = calls[0][0].shape[0]
    nbytes = sum(w.shape[0] * n_real(w) * gguf_bytes(w, bpw) + x.numel() * x.element_size()
                 + 4 * m * n_real(w) for x, w in calls)
    ops = sum(2 * m * w.shape[0] * n_real(w) for _, w in calls)
    bms, bby = bound_ms(nbytes, ops, "bf16")
    out = dict(ms=cuda_ms(lambda: run(fn, calls), 5), bound_ms=bms, bound_by=bby)
    if groups:
        out["ms_by_group"] = {name: cuda_ms(lambda idx=idx: run(fn, [calls[i] for i in idx]), 5)
                              for name, idx in groups.items()}
    if check:
        errs, maxabs = [], 0.0
        for x, w in (calls[i] for i in check):
            a, b = fn(x, w), plain(x, w)
            errs.append(nmse(a, b))
            maxabs = max(maxabs, float((a - b).abs().max()))
        dense = [w.dequant(torch.bfloat16) for _, w in calls]
        xb = {id(x): x.to(torch.bfloat16) for x, _ in calls}

        def lib():
            for (x, _), wd in zip(calls, dense):
                torch.matmul(xb[id(x)], wd)

        out.update(nmse=max(errs), max_abs_err=maxabs,
                   plain_ms=cuda_ms(lambda: run(plain, calls), 1), library_ms=cuda_ms(lib, 5))
    return out


def prompt_ids(tok, n: int) -> list[int]:
    """The first n ids of a sentence repeated (8 times for a byte-level SPM
    vocab; as often as a BPE vocab's merges need)."""
    line = ("The quick brown fox jumps over the lazy dog while the chip counts every "
            "byte it reads. ")
    for reps in (8, 32, 128):
        ids = tok.encode(line * reps, add_special=True, parse_special=True)[:n]
        if len(ids) == n:
            return ids
    fail(f"prompt tokenized to {len(ids)} ids, wanted {n}")


# presets made as users make them: `python -m zllm_torch.quantize` on an
# F16 file of the same model (kept in the cache for the next preset)
REQUANTIZED = ("Q4_K_M", "Q4_0", "Q5_K_M", "Q3_K_M", "IQ4_XS", *TQ_FTYPES, "BF16")
# the main paths' requantized files (the numpy quantizer takes 30-70 s a
# file, IQ4_XS's 2-3 minutes; TQ2_0, TQ1_0 and BF16 among them) and the
# TinyLlama Q5_0, Q5_1, Q2_K, IQ4_NL, MXFP4 and Q8_0 (the imatrix slice's,
# after TQ1_0 in its child: with a child of its own, the first Q4_K_M path
# waited ≈ 55 s longer for its file in one run) factory files: one child
# process a group makes them (`prepare_requantized`; children that share a
# model's F16 file wait for the one that writes it, `f16_file`), and
# gguf_file waits for its file's child.  The files the first main paths
# need (the TinyLlama Q4_K_M in a child of its own) start before the build
PREQUANTIZE = (("tinyllama", ("Q4_K_M",)), ("tinyllama", ("Q4_0", "Q5_K_M")),
               ("qwen25", ("Q4_K_M",)))
# and the rest after it (ten children beside the nvccs took a 40 s build to
# 95-120 s)
PREQUANTIZE_LATE = (("tinyllama", ("Q5_0", "Q5_1")), ("tinyllama", ("Q3_K_M",)),
                    ("tinyllama", ("IQ4_XS",)), ("tinyllama", ("Q2_K", "IQ4_NL", "MXFP4")),
                    ("tinyllama", IQ_FTYPES[:3]), ("tinyllama", IQ_FTYPES[3:]),
                    ("tinyllama", ("TQ2_0", "BF16")), ("tinyllama", ("TQ1_0", "Q8_0")))
_CHILDREN: dict[Path, subprocess.Popen] = {}


def prepare_requantized(groups=PREQUANTIZE):
    """Start a child (`chip_smoke.py --make-gguf NAME FTYPE...`) for each
    group of `groups` whose files are not cached yet; a child nices itself,
    so the kernels' `nvcc`s, which build meanwhile, keep the cores first."""
    import atexit

    for name, ftypes in groups:
        paths = [CACHE / f"{name}_{f.lower()}.gguf" for f in ftypes]
        if all(p.exists() for p in paths):
            continue
        child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--make-gguf",
                                  name, *ftypes], cwd=REPO, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)
        _CHILDREN.update(dict.fromkeys(paths, child))
    atexit.register(lambda: [c.kill() for c in _CHILDREN.values() if c.poll() is None])


def _write_atomic(path: Path, write):
    """write(tmp) and then rename it to path, so a reader never sees a
    file half written (tmp is this process's own)."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)


def f16_file(name: str, shape: dict) -> Path:
    """The model's F16 file (cached), the requantized presets' source.  One
    process writes it (the holder of its lock file); the others that need
    it wait for it rather than write the same gigabytes beside it."""
    from zllm_torch.gguf.constants import GGMLType
    from zllm_torch.testing import make_llama_gguf

    src = CACHE / f"{name}_f16.gguf"
    lock = src.with_name(src.name + ".lock")
    deadline = time.time() + 900
    while not src.exists():
        try:
            os.close(os.open(lock, os.O_CREAT | os.O_EXCL))
        except FileExistsError:  # another process writes it
            if time.time() > deadline:
                fail(f"{src.name}: its writer held {lock.name} for 900 s")
            time.sleep(0.5)
            continue
        try:
            if not src.exists():
                _write_atomic(src, lambda p: make_llama_gguf(
                    str(p), **dict(shape, with_tokenizer=True), gtype=GGMLType.F16, seed=0))
        finally:
            lock.unlink()
    return src


def gguf_file(name: str, shape: dict, ftype: str) -> tuple[Path, float]:
    """A random-weight llama, OLMo-2, Qwen, Gemma, MoE or layer-norm GGUF
    (`shape` may name the arch) in `ftype` (cached): the REQUANTIZED presets
    made by `python -m zllm_torch.quantize` from the model's F16 file, the
    IQ_FTYPES presets and a Gemma, MoE or layer-norm file's presets by the
    factory's `ftype=` (each
    tensor in the type `pick_type` gives its role, as the quantizer's; a
    2.6B model's F16 file and its numpy requantization would take minutes),
    any other type written directly by the factory.  Returns (path,
    seconds to make it)."""
    from zllm_torch.gguf.constants import GGMLType
    from zllm_torch.testing import LAYER_NORM_ARCHES, make_llama_gguf

    path = CACHE / f"{name}_{ftype.lower()}.gguf"
    shape = dict(shape, with_tokenizer=True)
    t0 = time.perf_counter()
    child = _CHILDREN.pop(path, None)
    if child is not None:
        if not hasattr(child, "err"):  # its first file: wait for it, read its errors
            child.err = child.communicate(timeout=900)[1]
        if child.returncode != 0:
            fail(f"making {path.name} failed: {child.err[-2000:]}")
    by_factory = ftype in IQ_FTYPES or ((shape.get("arch", "").startswith("gemma")
                                         or shape.get("n_experts", 0)
                                         or shape.get("arch") in LAYER_NORM_ARCHES)
                                        and ftype in REQUANTIZED)
    if not path.exists():
        if ftype in REQUANTIZED and not by_factory:
            src = f16_file(name, shape)

            def quantize(p):
                q = subprocess.run([sys.executable, "-m", "zllm_torch.quantize", str(src), str(p),
                                    ftype], cwd=REPO, capture_output=True, text=True, timeout=600)
                if q.returncode != 0:
                    fail(f"zllm_torch.quantize {ftype} failed: {q.stderr[-2000:]}")

            _write_atomic(path, quantize)
        elif by_factory:
            _write_atomic(path, lambda p: make_llama_gguf(str(p), **shape, ftype=ftype, seed=0))
        else:
            _write_atomic(path, lambda p: make_llama_gguf(str(p), **shape,
                                                          gtype=GGMLType[ftype], seed=0))
    return path, time.perf_counter() - t0


def small_model_check(torch, ftype: str, name: str = "small", shape: dict = SMALL,
                      env: dict | None = None, kernels: dict | None = None, must=(),
                      kv_dtype=None):
    """Kernels on the GPU vs plain versions on the CPU, same model, same
    tokens fed to both (teacher forcing), logits compared each step; `env`
    set on both sides, and each kernel named in `must` launched on the
    GPU (over a `kv_dtype` cache, bf16 by default: with float16, every
    launch of them in its f16 form)."""
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    path, _ = gguf_file(name, shape, ftype)
    kv_dtype = kv_dtype or torch.bfloat16
    runs = {}
    for dev in ("cuda", "cpu"):
        m = Model.load(str(path), device=dev, dtype=torch.bfloat16)
        gen = Generator(m, max_len=256, prefill_chunk=16, kv_dtype=kv_dtype)
        runs[dev] = (m, gen)
    ids = prompt_ids(runs["cpu"][0].tokenizer, 40)
    cpu_gen, gpu_gen = runs["cpu"][1], runs["cuda"][1]
    before = {n: kernels[n].launches for n in must}
    before16 = {n: getattr(kernels[n], "f16_launches", 0) for n in must}
    with mock.patch.dict(os.environ, env or {}):
        cpu_logits = [cpu_gen.prefill(ids).float()]
        steps = [gpu_gen.prefill(ids).float().cpu()]
        tok = int(torch.argmax(cpu_logits[0]))
        for i in range(8):  # the CPU's greedy tokens drive both sides
            cpu_logits.append(cpu_gen._decode_one(tok, len(ids) + i).float())
            steps.append(gpu_gen._decode_one(tok, len(ids) + i).float().cpu())
            tok = int(torch.argmax(cpu_logits[-1]))
    launched = {n: kernels[n].launches - before[n] for n in must}
    launched16 = {n: getattr(kernels[n], "f16_launches", 0) - before16[n] for n in must}
    errs = [nmse(a, b) for a, b in zip(steps, cpu_logits)]
    agree = sum(int(torch.argmax(a)) == int(torch.argmax(b)) for a, b in zip(steps, cpu_logits))
    tol = 1e-3
    res = {"phase": "small_model_gpu_vs_cpu", "ftype": ftype, "shape": shape, "env": env or {},
           "kv_dtype": str(kv_dtype)[6:], "gpu_f16_launches": launched16,
           "logits_nmse_max": max(errs), "logits_nmse_by_step": errs, "tolerance": tol, "argmax_agree": f"{agree}/{len(errs)}",
           "finite": all(bool(torch.isfinite(a).all()) for a in steps), "gpu_launches": launched}
    emit(res)
    if not res["finite"] or max(errs) > tol:
        fail(f"small-model GPU logits disagree with the CPU plain path: {res}")
    if not all(launched.values()):
        fail(f"small-model GPU run did not launch {must}: {res}")
    if kv_dtype == torch.float16 and launched16 != launched:
        fail(f"small-model GPU run over an f16 cache launched a form other than f16: {res}")


def main_shapes() -> dict:
    """Each main path's model: its factory shape and its label."""
    from zllm_torch import testing as zt

    return {"tinyllama": (zt.TINYLLAMA_SHAPE, "tinyllama-geometry"),
            "olmo2": (zt.OLMO2_1B_SHAPE, "OLMo-2-0425-1B geometry"),
            "qwen3": (zt.QWEN3_1_7B_SHAPE, "Qwen3-1.7B geometry"),
            "qwen25": (zt.QWEN25_1_5B_SHAPE, "Qwen2.5-1.5B geometry"),
            "gemma2_2b": (dict(zt.GEMMA2_2B_SHAPE, n_layers=GEMMA2_LAYERS),
                          f"Gemma-2-2B geometry ({GEMMA2_LAYERS} of its 26 layers)"),
            "gemma3_4b": (dict(zt.GEMMA3_4B_SHAPE, n_layers=GEMMA3_LAYERS),
                          f"Gemma-3-4B geometry ({GEMMA3_LAYERS} of its 34 layers)"),
            "gemma_2b": (zt.GEMMA_2B_SHAPE, "Gemma-2B geometry"),
            "gemma2_2layer": (dict(zt.GEMMA2_2B_SHAPE, n_layers=2,
                                   sliding_window=GEMMA2_CHECK_WINDOW),
                              f"Gemma-2-2B width, 2 layers, window {GEMMA2_CHECK_WINDOW} "
                              "(the model's 4096)"),
            "gemma3_2layer": (dict(zt.GEMMA3_4B_SHAPE, n_layers=2),
                              "Gemma-3-4B width, 2 layers (both windowed)"),
            MOE_MAIN: (dict(zt.QWEN3_30B_A3B_SHAPE, n_layers=MOE_LAYERS),
                       f"Qwen3-30B-A3B geometry ({MOE_LAYERS} of its 48 layers)"),
            "mixtral_2layer": (dict(zt.MIXTRAL_8X7B_SHAPE, n_layers=2),
                               "Mixtral-8x7B width, 2 layers"),
            "qwen15_moe_2layer": (dict(zt.QWEN15_MOE_A27B_SHAPE, n_layers=2),
                                  "Qwen1.5-MoE-A2.7B width, 2 layers"),
            LN_MAIN: (zt.PYTHIA_1_4B_SHAPE, "Pythia-1.4B geometry"),
            LN_SERVE: (dict(zt.STARCODER2_3B_SHAPE, n_layers=LN_SERVE_LAYERS),
                       f"StarCoder2-3B geometry ({LN_SERVE_LAYERS} of its 30 layers)"),
            "pythia_2layer": (dict(zt.PYTHIA_1_4B_SHAPE, n_layers=2),
                              "Pythia-1.4B width, 2 layers"),
            "stablelm2_2layer": (dict(zt.STABLELM2_1_6B_SHAPE, n_layers=2),
                                 "StableLM-2-1.6B width, 2 layers"),
            "starcoder2_2layer": (dict(zt.STARCODER2_3B_SHAPE, n_layers=2),
                                  "StarCoder2-3B width, 2 layers"),
            OSS_MAIN: (dict(zt.GPT_OSS_20B_SHAPE, n_layers=OSS_LAYERS),
                       f"gpt-oss-20b geometry ({OSS_LAYERS} of its 24 layers)"),
            OSS_CHECK: (dict(zt.GPT_OSS_20B_SHAPE, n_layers=2), "gpt-oss-20b width, 2 layers")}


def f16_counts(kernels: dict, zero: bool = False) -> dict:
    """The f16-form launch counters of the kernels that have one (K2, K6,
    K9, K10), set to 0 first when `zero`."""
    out = {}
    for name, fn in kernels.items():
        if hasattr(fn, "f16_launches"):
            if zero:
                fn.f16_launches = 0
            out[name] = fn.f16_launches
    return out


def main_path(torch, ftype: str, kernels: dict, want, card: str, name: str = "tinyllama",
              new_tokens: int = NEW_TOKENS, kv_dtype=None, model=None,
              prompt_tokens: int = PROMPT_TOKENS, max_len: int = MAX_LEN):
    """Load the `name` model of main_shapes() (TinyLlama, OLMo-2-0425-1B,
    Qwen3-1.7B or Qwen2.5-1.5B geometry; or take `model`, already loaded
    from that file), warm up, then one generate of
    `new_tokens` with the launch counters set to 0 just before and read
    just after, over a `kv_dtype` cache (bf16 by default; float16 for the
    f16 path, whose K2 and K6 launches must all take their f16 forms);
    `want(cfg, n_steps, n_chunks)` gives the expected counts; then the last
    decode step's device time from a CUDA graph (`step_graph_ms`) and, run
    eagerly, its CUDA kernels by name (`step_profile`); `prompt_tokens`
    and the cache's `max_len` (Gemma's paths: prompts past the window).
    Returns
    the model, the counts, the generator, the prompt's and generated tokens
    and the step's ms."""
    from zllm_torch.models.llama import forward
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.generate import Generator

    shape, label = main_shapes()[name]
    kv_dtype = kv_dtype or torch.bfloat16
    t_gguf = t_load = 0.0
    if model is None:
        path, t_gguf = gguf_file(name, shape, ftype)
        t0 = time.perf_counter()
        model = Model.load(str(path), device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    cfg = model.cfg
    gen = Generator(model, max_len=max_len, prefill_chunk=CHUNK, kv_dtype=kv_dtype)
    ids = prompt_ids(model.tokenizer, prompt_tokens)

    gen.generate(ids[:CHUNK + 8], max_new=4)  # warm-up: both chunk shapes, decode
    gen.reset()
    for fn in kernels.values():
        fn.launches = 0
    k6 = kernels["flash_attention"]
    k6.mma_launches = 0
    f16_counts(kernels, zero=True)
    res = gen.generate(ids, max_new=new_tokens)
    counts = {name: fn.launches for name, fn in kernels.items()}
    k6_mma = k6.mma_launches
    f16 = f16_counts(kernels)
    f16_expected = {n: counts[n] if kv_dtype == torch.float16 else 0 for n in f16}
    n_chunks = -(-prompt_tokens // CHUNK)
    n_steps = len(res.tokens) - 1
    expected = want(cfg, n_steps, n_chunks)
    last_logits = gen._decode_one(res.tokens[-1], prompt_tokens + n_steps).float()
    torch.cuda.synchronize()
    # the same step's forward captured in a CUDA graph: its device time with
    # the kernels and torch ops interleaved as the step runs them
    tok_t = torch.tensor([[res.tokens[-1]]], dtype=torch.int32, device="cuda")
    pos_t = torch.tensor([[prompt_tokens + n_steps]], dtype=torch.int32, device="cuda")

    def step():
        with torch.inference_mode():
            forward(model.params, cfg, tok_t, pos_t, gen.kv, logits_for="last")

    step_ms = cuda_ms(step, 20)
    profile_ = step_profile(torch, step)
    emit({"phase": "main_path", "model": f"{label} {ftype} (random weights, seed 0)",
          "shape": shape, "dtype": "bfloat16", "kv_dtype": str(kv_dtype)[6:],
          "prompt_tokens": prompt_tokens, "max_len": max_len,
          "prefill_chunks": n_chunks, "new_tokens": len(res.tokens),
          "prefill_tok_s": prompt_tokens / res.t_prefill,
          "decode_tok_s": n_steps / res.t_decode, "t_prefill_s": res.t_prefill,
          "t_decode_s": res.t_decode, "gguf_build_s": t_gguf, "load_s": t_load,
          "launches": counts, "launches_expected": expected,
          "flash_attention_mma_launches": k6_mma, "f16_launches": f16,
          "f16_launches_expected": f16_expected, "step_graph_ms": step_ms,
          "step_profile": profile_, "card": card})
    if n_steps != new_tokens - 1:
        fail(f"{ftype}: generate stopped after {len(res.tokens)} tokens")
    if counts != expected:
        fail(f"{ftype}: kernel launch counts {counts} != expected {expected}")
    if k6_mma != counts["flash_attention"]:  # the Generator's bf16 or f16 cache
        fail(f"{ftype}: {k6_mma} of {counts['flash_attention']} K6 launches took the "
             "tensor-core form")
    if f16 != f16_expected:
        fail(f"{ftype} ({kv_dtype} KV): f16-form launches {f16} != expected {f16_expected}")
    if last_logits.shape != (cfg.vocab_size,) or not bool(torch.isfinite(last_logits).all()):
        fail(f"{ftype}: main-path logits are not finite or have the wrong shape")
    return model, counts, gen, ids, res.tokens, step_ms


def decode_steps(torch, gen, kernels: dict, ids: list, tokens: list, env: str = ""):
    """Prefill the prompt, then SWITCH_STEPS decode steps fed the main
    path's greedy tokens, with `env`=1 set for the steps alone and the
    launch counts set to 0 just before them.  Returns the steps' logits."""
    gen.reset()
    gen.prefill(ids)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    with mock.patch.dict(os.environ, {env: "1"} if env else {}):
        out = [gen._decode_one(tok, len(ids) + i).float()
               for i, tok in enumerate(tokens[:SWITCH_STEPS])]
        torch.cuda.synchronize()
    return out


def switch_phase(torch, gen, kernels: dict, ids: list, tokens: list, card: str, *, phase: str,
                 model: str, env: str, expected: dict, k1_logits: list) -> dict:
    """A main-path model's decode steps with `env`=1 against the same steps
    through K1 (`k1_logits`, from decode_steps without it): the launches
    must be `expected` and the logits bit-identical to K1's (K11 and K12
    apply K1's integer dots and epilogue in K1's order).  Returns the
    counts."""
    logits = decode_steps(torch, gen, kernels, ids, tokens, env)
    counts = {name: fn.launches for name, fn in kernels.items()}
    expected = dict({name: 0 for name in kernels}, **expected)
    errs = [nmse(a, b) for a, b in zip(logits, k1_logits)]
    same = all(torch.equal(a, b) for a, b in zip(logits, k1_logits))
    emit({"phase": phase, "model": model, "env": f"{env}=1", "decode_steps": SWITCH_STEPS,
          "launches": counts, "launches_expected": expected, "logits_nmse_vs_k1_max": max(errs),
          "tolerance": 0.0, "logits_bitwise_equal_k1": same, "card": card})
    if counts != expected:
        fail(f"{phase}: kernel launch counts {counts} != expected {expected}")
    if not same:
        fail(f"{phase}: logits differ from the K1 run's (nmse {max(errs)})")
    return counts


def wait_done(reqs, seconds: float = 300.0):
    deadline = time.time() + seconds
    while not all(r.done for r in reqs):
        if time.time() > deadline:
            fail("engine requests did not finish in time")
        time.sleep(0.005)


# configurations of the small engine check: the model, engine keywords, the
# attention kernels its GPU run must launch (every other one must not)
ATTENTION_KERNELS = ("attn_decode_qkv", "attn_decode_update", "flash_attention",
                     "flash_attention_blockwise", "paged_attention", "paged_attn_decode_update")
SMALL_ENGINE_LAYOUTS = {
    "paged": ("small", "Q4_K_M", dict(kv_dtype="f32"),
              ("paged_attention", "paged_attn_decode_update")),
    "contiguous": ("small", "Q4_K_M", dict(kv_dtype="f32", kv_layout="contiguous"),
                   ("attn_decode_qkv", "flash_attention")),
    "q8": ("small", "Q4_K_M", dict(kv_dtype="q8"), ("flash_attention_blockwise",)),
    "olmo2_contiguous": ("small_olmo2", "Q4_K_M", dict(kv_dtype="f32", kv_layout="contiguous"),
                         ("attn_decode_update", "flash_attention")),
    "olmo2_paged": ("small_olmo2", "Q4_K_M", dict(kv_dtype="f32"),
                    ("paged_attention", "paged_attn_decode_update")),
    "q4_0_paged": ("small", "Q4_0", dict(kv_dtype="f32"),
                   ("paged_attention", "paged_attn_decode_update")),
    # Q5_K_M: wq, wk, wo, gate|up, down Q5_K (K1, K3), wv and the head Q6_K
    "q5_k_m_paged": ("small", "Q5_K_M", dict(kv_dtype="f32"),
                     ("paged_attention", "paged_attn_decode_update")),
    # Q3_K_M: wq, wk, wo, gate|up, down Q3_K (K4, K5), wv Q5_K (K1, K3), the
    # head Q6_K; 4 slots, so a decode step's GEMMs run K5 at M = 4
    "q3_k_m_paged": ("small", "Q3_K_M", dict(kv_dtype="f32", n_slots=4),
                     ("paged_attention", "paged_attn_decode_update", "dequant_gemm")),
    # IQ3_XXS (the factory's preset): wq, wk, wo, gate|up, down IQ3_XXS (K4,
    # K5), wv Q4_K and the head Q5_K (K1, K3); 4 slots: K5 at M = 4
    "iq3_xxs_paged": ("small", "IQ3_XXS", dict(kv_dtype="f32", n_slots=4),
                      ("paged_attention", "paged_attn_decode_update", "dequant_gemm")),
    # Qwen2 (G 6, head_dim 128, q/k/v biases; wv Q6_K, so no wqkv)
    "qwen2_paged": ("small_qwen2", "Q4_K_M", dict(kv_dtype="f32"),
                    ("paged_attention", "paged_attn_decode_update")),
    "qwen2_q8": ("small_qwen2", "Q4_K_M", dict(kv_dtype="q8"), ("flash_attention_blockwise",)),
    # the f16 cache (`--kv-type f16`), 4 slots: K9/K10 and K2/K6 in their f16
    # forms, every launch of them
    "f16_paged": ("small", "Q4_K_M", dict(kv_dtype="f16", n_slots=4),
                  ("paged_attention", "paged_attn_decode_update")),
    "f16_contiguous": ("small", "Q4_K_M", dict(kv_dtype="f16", kv_layout="contiguous",
                                               n_slots=4), ("attn_decode_qkv", "flash_attention")),
    # OLMo-2 over the contiguous f16 cache, 4 slots: K8 and K6 in their f16
    # forms, every launch of them
    "olmo2_contiguous_f16": ("small_olmo2", "Q4_K_M", dict(kv_dtype="f16", kv_layout="contiguous",
                                                           n_slots=4),
                             ("attn_decode_update", "flash_attention")),
    # TQ2_0 (zllm_torch.quantize: every matmul TQ2_0, the head Q6_K), 4
    # slots: a decode step's GEMMs run K5's TQ form at M = 4
    "tq2_0_paged": ("small", "TQ2_0", dict(kv_dtype="f32", n_slots=4),
                    ("paged_attention", "paged_attn_decode_update", "dequant_gemm")),
}
# group 11's engine check (run there, not with the layouts above): the
# StarCoder2 file on the q8 cache, K7 at G 12, d 128
LN_ENGINE_LAYOUTS = {"starcoder2_q8": ("small_starcoder2", "Q4_K", dict(kv_dtype="q8"),
                                       ("flash_attention_blockwise",))}
# the chat prompt a BPE-vocab engine check sends in a wave of its own after
# the others, and whose streamed text (the IncrementalDecoder's pieces) it
# prints
CHAT_PROMPT = "<|im_start|>user\nGrüße aus 東京 — ¿qué tal? 😀<|im_end|>\n<|im_start|>assistant\n"


# a sampled logits row of the small engine, GPU against CPU, while both
# sides have seen the same tokens: f32 sum order, and a bf16 rounding of a
# GEMM operand that it moves, leave nmse ~1e-5 and up to ~4e-3 a logit on
# the H100, in every layout
ENGINE_NMSE = 1e-4
# the layouts whose run on random weights meets a step with a top-two gap
# within such a difference, and the widest gap at which the two engines'
# tokens may part (twice the largest difference, rounded up)
TIE_LAYOUTS = ("q4_0_paged",)
TIE_GAP = 1e-2


def small_engine_check(torch, kernels: dict, layout: str):
    """The continuous-batching Engine on the GPU (kernels) and on the CPU
    (plain versions): a 2-layer Q4_K_M, Q4_0, Q5_K_M or Q3_K_M file (llama
    or OLMo-2) in f32, 2 slots (or the layout's n_slots), max_len 256, chunk
    16, greedy, in one configuration of SMALL_ENGINE_LAYOUTS.  Each wave is
    submitted from the engine thread between two steps, so both engines
    admit it at the same step.  Counters, finish reasons and reuse must be
    equal, and every sampled logits row made from the same tokens on both
    sides within ENGINE_NMSE of the CPU's.
    Tokens must be identical, except in a layout of TIE_LAYOUTS, where a
    request's tokens may part at one sampled step after its first: there
    the GPU must take the CPU's second token, and the CPU's top-two gap be
    at most TIE_GAP and at most twice that row's largest GPU-vs-CPU logit
    difference.  Returns the GPU run's launches."""
    from zllm_torch.models.loader import Model
    from zllm_torch.server.engine import Engine, Request

    from zllm_torch.tokenizer import IncrementalDecoder

    name, ftype, kw, must = {**SMALL_ENGINE_LAYOUTS, **LN_ENGINE_LAYOUTS}[layout]
    shape = SMALL_SHAPES[name]
    path, _ = gguf_file(name, shape, ftype)
    rng = random.Random(0)

    def ids(n):
        return [1] + [rng.randrange(3, SMALL["vocab_size"]) for _ in range(n - 1)]

    p_long = ids(140)  # crosses the first 128-token page
    waves = [[ids(40), p_long, ids(25)], [p_long[:130] + [7]]]
    bpe = shape.get("tokenizer") == "bpe"
    streamed = {}
    must_not = [n for n in ATTENTION_KERNELS if n not in must]
    kw = dict(dict(n_slots=2), **kw)
    kw["kv_dtype"] = {"f32": torch.float32, "f16": torch.float16}.get(kw["kv_dtype"],
                                                                      kw["kv_dtype"])
    runs, logits = {}, {"cuda": {}, "cpu": {}}
    for dev in ("cuda", "cpu"):
        m = Model.load(str(path), device=dev, dtype=torch.float32)
        eng = Engine(m, max_len=256, prefill_chunk=16, **kw)
        if bpe and dev == "cuda":  # a non-ASCII chat prompt, last
            chat = m.tokenizer.encode(CHAT_PROMPT, add_special=True, parse_special=True)
            if m.tokenizer.decode(chat) != CHAT_PROMPT.replace("<|im_start|>", "").replace(
                    "<|im_end|>", ""):
                fail(f"small engine ({layout}): the chat prompt does not decode to its text")
            waves.append([chat])

        def record(lg, cols, slots, _real=eng._sample_and_emit, _rec=logits[dev]):
            rows = lg.float().cpu()
            for s_ in slots:  # each request's sampled logits rows, by its prompt
                _rec.setdefault(tuple(s_.req.prompt_tokens), []).append(
                    rows[s_.idx, int(cols[s_.idx])])
            return _real(lg, cols, slots)

        eng._sample_and_emit = record
        before = {name: fn.launches for name, fn in kernels.items()}
        before16 = f16_counts(kernels)
        eng.start()
        try:
            got = []
            for wave in waves:
                reqs = eng.run_in_loop(lambda wave=wave: [
                    eng.submit(Request(prompt_tokens=p, max_new=8, temp=0.0)) for p in wave])
                wait_done(reqs)
                got += [(tuple(r.prompt_tokens), r.out_tokens, r.finish_reason, r.n_prompt_reused,
                         r.error) for r in reqs]
            if bpe:  # the chat request, streamed as the server streams it
                dec = IncrementalDecoder(m.tokenizer)
                streamed[dev] = [dec.push(t) for t in reqs[-1].out_tokens] + [dec.flush()]
        finally:
            eng.stop()
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (got, {k: eng.metrics[k] for k in ENGINE_COUNTERS},
                     {name: fn.launches - before[name] for name, fn in kernels.items()},
                     {name: n - before16[name] for name, n in f16_counts(kernels).items()})
    (g_got, g_cnt, g_k, g_16), (c_got, c_cnt, *_) = runs["cuda"], runs["cpu"]
    want16 = {n: g_k[n] if kw["kv_dtype"] == torch.float16 else 0 for n in g_16}
    per_req, bad = [], []
    for (prompt, g_toks, *_), (_, c_toks, *_) in zip(g_got, c_got):
        g_rows, c_rows = logits["cuda"][prompt], logits["cpu"][prompt]
        if (len(g_rows), len(c_rows)) != (len(g_toks), len(c_toks)):
            fail(f"small engine ({layout}): {len(g_rows)}/{len(c_rows)} logits rows recorded "
                 f"for {len(g_toks)}/{len(c_toks)} tokens")
        part = next((i for i, (a, b) in enumerate(zip(g_toks, c_toks)) if a != b), None)
        shared = len(c_rows) if part is None else part + 1  # rows made from the same tokens
        pairs = list(zip(g_rows[:shared], c_rows[:shared]))
        req = {"tokens": len(c_toks), "parted_at": part,
               "logits_nmse_max": max((nmse(a, b) for a, b in pairs), default=0.0),
               "logit_diff_max": max((float((a - b).abs().max()) for a, b in pairs), default=0.0)}
        if req["logits_nmse_max"] > ENGINE_NMSE:
            bad.append(f"logits nmse {req['logits_nmse_max']}")
        if part is not None:
            top = c_rows[part].topk(2)
            req.update(cpu_top2_gap=float(top.values[0] - top.values[1]),
                       logit_diff_at_part=float((g_rows[part] - c_rows[part]).abs().max()),
                       gpu_took_cpu_second=int(top.indices[1]) == g_toks[part])
            if not (layout in TIE_LAYOUTS and part >= 1 and req["gpu_took_cpu_second"]
                    and req["cpu_top2_gap"] <= min(TIE_GAP, 2 * req["logit_diff_at_part"])):
                bad.append(f"tokens part at step {part} with no near tie there: {req}")
        per_req.append(req)
    # contiguous: a mixed step attends column 0 once more through the T=1
    # kernel, K2 (llama) or K8 (OLMo-2), as a decode step does
    want = {}
    if kw.get("kv_layout") == "contiguous":
        n_l = shape["n_layers"]
        dec, pre = g_cnt["decode_steps_total"], g_cnt["prefill_steps_total"]
        t1 = "attn_decode_update" if name == "small_olmo2" else "attn_decode_qkv"
        want = {t1: n_l * (dec + pre), "flash_attention": n_l * pre}
    res = {"phase": "small_engine_gpu_vs_cpu", "layout": layout, "ftype": ftype,
           "shape": shape, "dtype": "float32",
           "kv": str(kw["kv_dtype"]), "n_slots": kw["n_slots"], "max_len": 256, "chunk": 16,
           "tokens_equal": g_got == c_got, "requests": per_req, "logits_nmse_tolerance": ENGINE_NMSE,
           "tie_gap_limit": TIE_GAP if layout in TIE_LAYOUTS else 0.0,
           "counters_equal": g_cnt == c_cnt, "counters": g_cnt,
           "n_prompt_reused": [r[3] for r in g_got], "gpu_launches": g_k,
           "gpu_launches_expected": want, "gpu_f16_launches": g_16,
           "gpu_f16_launches_expected": want16, "chat_prompt": CHAT_PROMPT if bpe else "",
           "chat_streamed_pieces": streamed.get("cuda", [])}
    emit(res)
    if any(r[4] for r in g_got + c_got):
        fail(f"engine errors: {[r[4] for r in g_got + c_got]}")
    if streamed.get("cuda") != streamed.get("cpu"):
        bad.append(f"streamed chat text {streamed}")
    if bad or [r[2:] for r in g_got] != [r[2:] for r in c_got] or g_cnt != c_cnt:
        fail(f"GPU engine disagrees with the CPU engine ({layout}): {bad}; {g_got} / {c_got}, "
             f"{g_cnt} / {c_cnt}")
    # the re-send reuses 128 (a whole page) or, contiguous, its 130 tokens
    if g_got[3][3] < 128 or not all(g_k[n] for n in must) or any(g_k[n] for n in must_not) \
            or any(g_k[n] != c for n, c in want.items()) or g_16 != want16:
        fail(f"small engine run ({layout}) reused no prefix or launched the wrong kernels: {res}")
    return g_k


def serve_expected(kernels: dict, cfg, steps: dict, q8: bool = False, contig: bool = False,
                   gemms: dict | None = None, att_layers: int | None = None) -> dict:
    """The kernel launches an engine's steps (`steps`: its counter deltas)
    make: `gemms` a step by kernel (by default the TinyLlama Q4_K_M
    model's), and the layout's attention in `att_layers` layers (all; the
    ring cache's full layers: its windowed ones attend with plain torch
    ops)."""
    dec, pre = steps["decode_steps_total"], steps["prefill_steps_total"]
    L = cfg.n_layers
    low = L // 2
    expected = {name: 0 for name in kernels}
    if gemms is None:  # Q4_K_M: Q4_K but wv and the first L/2 ffn_down, and the Q6_K head
        gemms = {"q4k_gemm": 4 * L + (L - low), "dequant_gemm": L + low + 1}
    expected.update({name: n * (dec + pre) for name, n in gemms.items()})
    L = L if att_layers is None else att_layers
    # a mixed step attends column 0 (a generating row's token) once more
    # through the T=1 kernel, as a decode step does (models/llama.py:
    # `_attend`; over the contiguous stripe K2 in `layer_forward`)
    if q8:
        expected.update(flash_attention_blockwise=L * (dec + 2 * pre))
    elif contig:  # the T=1 kernel: K8 for OLMo-2, K2 otherwise
        t1 = "attn_decode_update" if cfg.arch == "olmo2" else "attn_decode_qkv"
        expected.update({t1: L * (dec + pre), "flash_attention": L * pre})
    else:
        expected.update(paged_attn_decode_update=L * (dec + pre), paged_attention=L * pre)
    return expected


def serve_phase(torch, model, kernels: dict, card: str, kv_dtype=None,
                kv_layout: str = "auto", label: str = "tinyllama-geometry Q4_K_M",
                gemms: dict | None = None, tag: str = "", server_kw: dict | None = None,
                long_bytes: int = 0) -> dict:
    """The serving main path: ZllmServer (defaults; `kv_dtype="q8"` for the
    q8 KV cache, whose auto layout is the contiguous one; `kv_layout=
    "contiguous"` for the bf16 contiguous stripe; `kv_dtype=torch.float16`
    for the f16 cache on either layout, `--kv-type f16`, whose K9/K10 or
    K2/K6 (OLMo-2: K8/K6) launches must all take their f16 forms) over
    `model` (the TinyLlama-geometry Q4_K_M one unless `label` names
    another) on a local port.  `gemms`: the GEMM launches of one engine
    step by kernel (by default Q4_K_M's); `tag` names the phase apart;
    `server_kw` more ZllmServer keywords; `long_bytes` one more completion
    of that many bytes after the concurrent ones.  A windowed model's
    "auto" engine serves from the ring cache (`serve_ring`): K2/K6 in its
    full layers only.  Warm up, set the launch counts to 0, then the
    traffic; the counts must match the engine's own step counters exactly.
    Returns the counts."""
    from zllm_torch.models.llama import moe_ffn
    from zllm_torch.ops import attention as att
    from zllm_torch.runtime.kvcache import KVCacheSWA
    from zllm_torch.server.http import ZllmServer

    q8 = kv_dtype == "q8"
    f16 = kv_dtype == torch.float16
    srv = ZllmServer(model, port=0, kv_dtype=kv_dtype, kv_layout=kv_layout, **(server_kw or {}))
    srv.start_background()
    eng = srv.engine
    contig = not eng.paged and not q8
    ring = isinstance(eng.kv, KVCacheSWA)
    phase = ("serve_q8" if q8 else "serve_ring" if ring else "serve_contig" if contig
             else "serve") + ("_f16" if f16 else "")
    phase += f"_{tag}" if tag else ""
    # the mixed steps' attention must take the tensor-core loop (bf16 pools;
    # int8 codes at 1024 query rows a kv head; K6's bf16 form over the
    # contiguous stripe), counted apart on its wrapper
    mma_fn = (att.flash_attention_blockwise if q8 else att.flash_attention if contig
              else att.paged_attention)
    line = ("The quick brown fox jumps over the lazy dog while the chip counts every "
            "byte it reads. ")
    text = line * 8

    def post(path, body):
        return http_post(srv.port, path, body)

    def completion(n_bytes, tail=""):
        return {"prompt": text[:n_bytes] + tail, "max_tokens": SERVE_NEW_TOKENS,
                "temperature": 0}

    try:
        post("/v1/completions", completion(40))  # warm-up
        for fn in kernels.values():
            fn.launches = 0
        mma_fn.mma_launches = 0
        moe_ffn.routing = [] if model.cfg.moe is not None else None
        f16_counts(kernels, zero=True)
        m0 = dict(eng.metrics)
        ttft0 = (eng.hist_ttft.total, eng.hist_ttft.n)

        results = {}

        def client(n):
            results[n] = json.loads(post("/v1/completions", completion(n)))

        threads = [threading.Thread(target=client, args=(n,)) for n in SERVE_PROMPT_BYTES]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        window = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or len(results) != len(SERVE_PROMPT_BYTES):
            fail(f"{phase}: concurrent requests did not finish")
        long_out = None
        if long_bytes:
            long_out = json.loads(post("/v1/completions", {
                "prompt": (line * (long_bytes // len(line) + 1))[:long_bytes],
                "max_tokens": SERVE_NEW_TOKENS, "temperature": 0}))
        window_steps = sum(eng.metrics[k] - m0[k]
                           for k in ("decode_steps_total", "prefill_steps_total"))
        gen_tokens = sum(r["usage"]["completion_tokens"] for r in results.values())
        ttft_n = eng.hist_ttft.n - ttft0[1]
        ttft_mean = (eng.hist_ttft.total - ttft0[0]) / max(ttft_n, 1)

        events = [ln[6:] for ln in post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": text[:120]}], "stream": True,
            "max_tokens": SERVE_NEW_TOKENS, "temperature": 0}).splitlines()
            if ln.startswith("data: ")]
        chat_finish = json.loads(events[-2])["choices"][0]["finish_reason"] if len(events) > 1 else ""
        resend = json.loads(post("/v1/completions", completion(280, " and then it rests.")))
        reused = eng.metrics["tokens_prefix_reused_total"] - m0["tokens_prefix_reused_total"]
        sequential = {n: json.loads(post("/v1/completions", completion(n)))
                      for n in SERVE_PROMPT_BYTES}
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in kernels.items()}
        mma = mma_fn.mma_launches
        f16_got = f16_counts(kernels)
        m1 = dict(eng.metrics)
        routing = moe_ffn.routing
    finally:
        moe_ffn.routing = None
        srv.shutdown()

    steps = {k: m1[k] - m0[k] for k in ENGINE_COUNTERS}
    dec, pre = steps["decode_steps_total"], steps["prefill_steps_total"]
    ids_a, ids_b = (model.tokenizer.encode(completion(*c)["prompt"], add_special=True,
                                           parse_special=True)
                    for c in ((300,), (280, " and then it rests.")))
    shared = next((i for i, (x, y) in enumerate(zip(ids_a, ids_b)) if x != y),
                  min(len(ids_a), len(ids_b)))
    reuse_need = min(256, shared // eng.alloc.ps * eng.alloc.ps) if eng.paged else 1
    L = model.cfg.n_layers
    if ring:  # the kernels attend in the full layers alone
        L = sum(not w for w in eng.kv.swa_mask)
    expected = serve_expected(kernels, model.cfg, steps, q8, contig, gemms, att_layers=L)
    experts = expert_launches(routing or [])
    for name, n in experts.items():  # each layer's experts, from the recorded routing
        expected[name] += n
    # the cache's bytes against a bf16 contiguous cache of the same slots
    kv = eng.kv
    kv_bytes = kv_bytes_of(eng)
    kv_name = "float16" if f16 else "bfloat16"
    layout = {"kv_layout": "paged", "kv_dtype": kv_name, "page_size": eng.alloc.ps} if (
        eng.paged) else {"kv_layout": "contiguous", "kv_slots": kv.max_len, "kv_dtype":
                         "q8 (int8 codes + f32 scales)" if q8 else kv_name}
    if ring:
        layout.update(kv_layout="ring (KVCacheSWA)", ring_slots=kv.ring,
                      ring_layers=sum(kv.swa_mask), full_layers=L)
    bf16_bytes = 2 * model.cfg.n_layers * eng.n_slots * model.cfg.n_kv_heads * (
        eng.max_len if eng.paged else kv.max_len) * model.cfg.head_dim * 2
    finishes = [r["choices"][0]["finish_reason"] for r in
                (*results.values(), resend, *sequential.values(),
                 *([long_out] if long_out else []))] + [chat_finish]
    same = all(results[n]["choices"][0]["text"] == sequential[n]["choices"][0]["text"]
               for n in SERVE_PROMPT_BYTES)
    f16_want = {n: counts[n] if f16 else 0 for n in f16_got}
    emit({"phase": phase,
          "model": f"{label} (random weights, seed 0)",
          "dtype": "bfloat16", **layout, "n_slots": eng.n_slots,
          "max_len": eng.max_len, "chunk": eng.prefill_chunk, "kv_bytes": kv_bytes,
          "kv_bytes_bf16_contiguous": bf16_bytes, "kv_bytes_ratio": kv_bytes / bf16_bytes,
          "prompt_bytes": list(SERVE_PROMPT_BYTES), "max_tokens": SERVE_NEW_TOKENS,
          "concurrent_window_s": window, "window_steps": window_steps,
          "window_ms_per_step": 1e3 * window / max(window_steps, 1),
          "generated_tokens": gen_tokens,
          "generated_tok_s": gen_tokens / window, "requests_s": len(results) / window,
          "ttft_mean_s": ttft_mean, "ttft_n": ttft_n, "prefix_reused_after_resend": reused,
          "resend_shared_ids": shared, "prefix_reuse_expected_min": reuse_need,
          "concurrent_equals_sequential": same, "finish_reasons": finishes,
          "engine_counters": steps, "launches": counts, "launches_expected": expected,
          **({"expert_launches": experts, "moe_calls": len(routing)} if routing else {}),
          "mma_launches": mma, "mma_launches_expected": L * pre, "f16_launches": f16_got,
          "f16_launches_expected": f16_want, "card": card})
    if steps["engine_errors_total"] or m1["engine_errors_total"] or "error" in finishes \
            or "" in finishes:
        fail(f"{phase}: engine errors {steps['engine_errors_total']}, finishes {finishes}")
    if not same:
        fail(f"{phase}: concurrent texts differ from the same bodies sent one at a time: "
             f"{[(results[n]['choices'][0]['text'], sequential[n]['choices'][0]['text']) for n in SERVE_PROMPT_BYTES]}")
    # paged: the re-send shares two full pages (none where it shares fewer
    # ids with the 300-byte prompt, as a BPE vocab's 58); contiguous: an idle
    # slot's own prefix
    if reused < reuse_need:
        fail(f"{phase}: {reused} prompt tokens reused after the re-send, {reuse_need} expected")
    if counts != expected or not dec or not pre:
        fail(f"{phase}: kernel launch counts {counts} != expected {expected}")
    if mma != L * pre:
        fail(f"{phase}: {mma} of the {L * pre} mixed-step attentions took the tensor-core loop")
    if f16_got != f16_want:
        fail(f"{phase}: f16-form launches {f16_got} != expected {f16_want}")
    return dict(counts, mma_launches=mma)


def http_post(port: int, path: str, body: dict, timeout: float = 600) -> str:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


def letters(seed: int, n: int) -> str:
    """n seeded lowercase letters: n ids on the byte-level vocab (no
    spaces, which take three)."""
    r = random.Random(seed)
    return "".join(r.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(n))


def zero_counts(kernels: dict, mma_fns=()):
    for fn in kernels.values():
        fn.launches = 0
    for fn in mma_fns:
        fn.mma_launches = 0
    f16_counts(kernels, zero=True)


def engine_counts_check(torch, phase: str, kernels: dict, expected: dict, f16: bool,
                        mma_fn=None, mma_want: int | None = None) -> dict:
    """Read the launch counts after a window, hold them to `expected` (and
    the f16 forms' and the tensor-core loop's counts), fail otherwise.
    Returns the counts."""
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in kernels.items()}
    got16 = f16_counts(kernels)
    want16 = {n: counts[n] if f16 else 0 for n in got16}
    if counts != expected:
        fail(f"{phase}: kernel launch counts {counts} != expected {expected}")
    if got16 != want16:
        fail(f"{phase}: f16-form launches {got16} != expected {want16}")
    if mma_fn is not None and mma_fn.mma_launches != mma_want:
        fail(f"{phase}: {mma_fn.mma_launches} of the {mma_want} mixed-step attentions took the "
             "tensor-core loop")
    return counts


# the slot phases: a prompt of 5 x 128 + 1 ids, so its last token rides
# alone at column 0 of its last chunk both in the uninterrupted run and
# after a restore of its first 640 (the same kernel, the same bits)
SLOT_PROMPT_IDS = 641
SLOT_NEW_TOKENS = 32
SLOT_CASES = {  # phase -> ZllmServer keywords (4 slots, max_len 2048, chunk 128)
    "slots_paged_bf16": {},
    "slots_contiguous_bf16": {"kv_layout": "contiguous"},
    "slots_paged_f16": {"kv_dtype": "f16"},
    "slots_q8": {"kv_dtype": "q8"},
}


def slots_phase(torch, model, kernels: dict, card: str, phase: str) -> dict:
    """/slots save and restore at full width: the prompt P (641 ids),
    greedy, 32 tokens, gives the reference text R in slot 0; slot 0 is
    saved and erased; unrelated requests run in slot 0 until every saved
    position past the first is rewritten (the last layer's K differs
    there); the file restores into slot 1 with the tokens it holds; P again
    reuses the restored 640 and must give R (bf16, f16; q8: printed).
    Right after the restore, a save of slot 1 must hold the first file's
    k/v arrays bit for bit (bf16, f16); q8: the requantized codes and
    scales on the card must equal a CPU restore of the same file.  Every
    launch of the window is held to the engine's step counters."""
    import numpy as np

    from zllm_torch.ops import attention as att
    from zllm_torch.runtime import state
    from zllm_torch.runtime.kvcache import KVCacheQ8
    from zllm_torch.server.http import ZllmServer

    kw = dict(SLOT_CASES[phase])
    q8 = kw.get("kv_dtype") == "q8"
    f16 = kw.get("kv_dtype") == "f16"
    if f16:
        kw["kv_dtype"] = torch.float16
    contig = kw.get("kv_layout") == "contiguous"
    folder = CACHE / "slots"
    folder.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    srv = ZllmServer(model, port=0, slot_save_path=str(folder), **kw)
    srv.start_background()
    eng = srv.engine
    cfg = model.cfg
    L = cfg.n_layers
    mma_fn = (att.flash_attention_blockwise if q8 else att.flash_attention if contig
              else att.paged_attention)
    text = letters(1, SLOT_PROMPT_IDS - 1)
    ids = model.tokenizer.encode(text, add_special=True, parse_special=True)
    if len(ids) != SLOT_PROMPT_IDS:
        fail(f"{phase}: the prompt tokenized to {len(ids)} ids, not {SLOT_PROMPT_IDS}")
    body = {"prompt": text, "max_tokens": SLOT_NEW_TOKENS, "temperature": 0}

    def post(path, b):
        return json.loads(http_post(srv.port, path, b))

    def last_k_rows(slot, n, table_row=None):
        """The last layer's stored K of a slot's positions [0, n), [Hkv, n, D]."""
        k = eng.kv.k[L - 1]
        if eng.paged:
            pos = torch.arange(n, device=k.device)
            tbl = torch.as_tensor(np.asarray(table_row), device=k.device).long()
            return k[:, tbl[pos // eng.alloc.ps] * eng.alloc.ps + pos % eng.alloc.ps].clone()
        return k[slot, :, :n].clone()

    try:
        zero_counts(kernels, (mma_fn,))
        m0 = dict(eng.metrics)
        ref = post("/v1/completions", body)
        tokens = eng.run_in_loop(lambda: list(eng.slots[0].cache_tokens))
        if tokens[:SLOT_PROMPT_IDS] != ids:
            fail(f"{phase}: the prompt was not served from slot 0")
        save = post("/slots/0?action=save", {"filename": f"{phase}.bin"})
        n_past = save["n_past"]
        table0 = eng.alloc.table[0].copy() if eng.paged else None
        saved = last_k_rows(0, n_past, table0)
        post("/slots/0?action=erase", {})
        rounds = 0
        while True:  # unrelated traffic over slot 0's saved positions
            rounds += 1
            # an upper-case first letter: every position past the first
            # differs from P's (paged: the second request meets P's pages)
            post("/v1/completions", {"prompt": "Z" + letters(100 + rounds, 719),
                                     "max_tokens": 8, "temperature": 0})
            now = last_k_rows(0, n_past, table0)
            rewritten = (now != saved).flatten(start_dim=2).any(dim=2).any(dim=0)[1:]
            if bool(rewritten.all()):
                break
            if rounds == 4:
                fail(f"{phase}: {int((~rewritten).sum())} saved positions of slot 0 not "
                     "rewritten after 4 unrelated requests")
        restore = post("/slots/1?action=restore", {"filename": f"{phase}.bin", "tokens": tokens})
        if restore != {"id": 1, "n_past": n_past}:
            fail(f"{phase}: restore answered {restore}")
        first = np.load(folder / f"{phase}.bin")
        check = {}
        if q8:  # the card's requantized slot against the CPU's restore of the file
            cpu = KVCacheQ8.create(L, 1, n_past, cfg.n_kv_heads, cfg.head_dim, device="cpu")
            state.seq_load_file(str(folder / f"{phase}.bin"), model, cpu, 0)
            pairs = [(getattr(eng.kv, name)[il][1, :, :n_past].cpu(), getattr(cpu, name)[il][0])
                     for name in ("k", "v", "ks", "vs") for il in range(L)]
            check["q8_codes_scales_equal_cpu"] = all(torch.equal(a, b) for a, b in pairs)
            check["q8_codes_differing"] = sum(int((a != b).sum()) for a, b in pairs)
        else:  # a save of the restored slot: the first file's arrays, bit for bit
            post("/slots/1?action=save", {"filename": f"{phase}_again.bin"})
            again = np.load(folder / f"{phase}_again.bin")
            check["file_arrays_equal"] = all(
                first[n].dtype == again[n].dtype
                and np.array_equal(first[n].view(np.uint16), again[n].view(np.uint16))
                for n in ("k", "v"))
        reused0 = eng.metrics["tokens_prefix_reused_total"]
        out = post("/v1/completions", body)
        reused = eng.metrics["tokens_prefix_reused_total"] - reused0
        m1 = dict(eng.metrics)
    finally:
        srv.shutdown()
    steps = {k: m1[k] - m0[k] for k in ENGINE_COUNTERS}
    counts = engine_counts_check(torch, phase, kernels, serve_expected(kernels, cfg, steps, q8,
                                                                       contig),
                                 f16, mma_fn, L * steps["prefill_steps_total"])
    got, want = out["choices"][0]["text"], ref["choices"][0]["text"]
    agree = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    res = {"phase": phase, "model": "tinyllama-geometry Q4_K_M (random weights, seed 0)",
           "kv_layout": "paged" if eng.paged else "contiguous",
           "kv_dtype": "q8" if q8 else "float16" if f16 else "bfloat16",
           "prompt_ids": SLOT_PROMPT_IDS, "new_tokens": SLOT_NEW_TOKENS, "n_past": n_past,
           "file_bytes": os.path.getsize(folder / f"{phase}.bin"),
           "unrelated_requests": rounds, "restored_into": 1, "prefix_reused": reused,
           "text_equal": got == want, "chars_agreeing": agree, "text_chars": len(want),
           **check, "engine_counters": steps, "launches": counts,
           "mma_launches": mma_fn.mma_launches, "seconds": time.perf_counter() - t0,
           "card": card}
    emit(res)
    if steps["engine_errors_total"] or out["choices"][0]["finish_reason"] != "length":
        fail(f"{phase}: {res}")
    if reused != SLOT_PROMPT_IDS - 1:
        fail(f"{phase}: P again reused {reused} tokens, not the restored {SLOT_PROMPT_IDS - 1}")
    if not all(check.values() if not q8 else [check["q8_codes_scales_equal_cpu"]]):
        fail(f"{phase}: the restored state differs: {check}")
    if not q8 and got != want:
        fail(f"{phase}: the continuation after the restore differs from the uninterrupted run: "
             f"{got!r} / {want!r}")
    return dict(counts, mma_launches=mma_fn.mma_launches)


TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Get the weather",
    # enum-bounded so even a random-weights model must finish its call
    "parameters": {"type": "object", "properties": {"city": {"enum": ["Oslo", "Bergen"]}},
                   "required": ["city"]}}}]


def messages_infill_tools_phase(torch, model, kernels: dict, card: str) -> dict:
    """The Q4_K_M model behind ZllmServer (paged bf16): /v1/messages greedy
    text equal to /v1/chat/completions content for the same messages,
    count_tokens equal to usage.prompt_tokens; /infill over FIM ids grafted
    on byte tokens (as tests/test_server.py does) stopping with >= 1 token;
    a forced tool call streamed and not streamed giving the same parsed
    call, valid under the tool's schema.  Every slot is erased before each
    request, so each prompt is computed whole; the launches are held to the
    engine's step counters."""
    from zllm_torch.ops import attention as att
    from zllm_torch.server.http import ZllmServer

    t0 = time.perf_counter()
    srv = ZllmServer(model, port=0)
    srv.start_background()
    eng = srv.engine
    vocab = model.tokenizer.vocab
    msgs = [{"role": "user", "content": "Tell me what the chip reads first."}]
    tool_body = {"messages": [{"role": "user", "content": "weather in Oslo?"}], "tools": TOOLS,
                 "tool_choice": "required", "max_tokens": 160, "temperature": 0}

    def post(path, b, raw=False):
        for i in range(eng.n_slots):
            http_post(srv.port, f"/slots/{i}?action=erase", {})
        out = http_post(srv.port, path, b)
        return out if raw else json.loads(out)

    old = (vocab.fim_pre_id, vocab.fim_suf_id, vocab.fim_mid_id)
    try:
        zero_counts(kernels, (att.paged_attention,))
        m0 = dict(eng.metrics)
        anth = post("/v1/messages", {"messages": msgs, "max_tokens": 24, "temperature": 0})
        chat = post("/v1/chat/completions", {"messages": msgs, "max_tokens": 24,
                                             "temperature": 0})
        count = post("/v1/messages/count_tokens", {"messages": msgs})["input_tokens"]
        vocab.fim_pre_id, vocab.fim_suf_id, vocab.fim_mid_id = 10, 11, 12
        infill = post("/infill", {"input_prefix": "def add(a, b):\n    ",
                                  "input_suffix": "\n    return c\n", "max_tokens": 16,
                                  "temperature": 0})
        vocab.fim_pre_id, vocab.fim_suf_id, vocab.fim_mid_id = old
        plain = post("/v1/chat/completions", tool_body)
        events = [json.loads(ln[6:]) for ln in post("/v1/chat/completions",
                                                    dict(tool_body, stream=True),
                                                    raw=True).splitlines()
                  if ln.startswith("data: ") and ln != "data: [DONE]"]
        m1 = dict(eng.metrics)
    finally:
        vocab.fim_pre_id, vocab.fim_suf_id, vocab.fim_mid_id = old
        srv.shutdown()
    steps = {k: m1[k] - m0[k] for k in ENGINE_COUNTERS}
    counts = engine_counts_check(torch, "messages_infill_tools", kernels,
                                 serve_expected(kernels, model.cfg, steps), False,
                                 att.paged_attention,
                                 model.cfg.n_layers * steps["prefill_steps_total"])

    def parsed(calls):
        return [(c["function"]["name"], json.loads(c["function"]["arguments"])) for c in calls]

    streamed = [c for e in events for c in (e["choices"][0]["delta"] or {}).get("tool_calls", [])]
    finish_s = [e["choices"][0]["finish_reason"] for e in events if e["choices"][0]["finish_reason"]]
    plain_calls = parsed(plain["choices"][0]["message"].get("tool_calls") or [])
    res = {"phase": "messages_infill_tools",
           "model": "tinyllama-geometry Q4_K_M (random weights, seed 0)",
           "kv_layout": "paged", "messages_text": anth["content"][0]["text"],
           "messages_equal_chat": anth["content"][0]["text"]
           == chat["choices"][0]["message"]["content"],
           "messages_stop_reason": anth["stop_reason"], "count_tokens": count,
           "chat_prompt_tokens": chat["usage"]["prompt_tokens"],
           "infill": infill, "tool_call": plain_calls, "tool_call_streamed": parsed(streamed),
           "tool_finish": [plain["choices"][0]["finish_reason"]] + finish_s,
           "tool_prompt_tokens": plain["usage"]["prompt_tokens"], "engine_counters": steps,
           "launches": counts, "seconds": time.perf_counter() - t0, "card": card}
    emit(res)
    if steps["engine_errors_total"]:
        fail(f"messages_infill_tools: engine errors {steps}")
    if not res["messages_equal_chat"] or count != res["chat_prompt_tokens"] \
            or anth["usage"]["input_tokens"] != count:
        fail(f"messages_infill_tools: /v1/messages differs from the chat route: {res}")
    if infill["tokens_predicted"] < 1 or infill["stop_type"] not in ("stop", "length"):
        fail(f"messages_infill_tools: /infill {infill}")
    if not plain_calls or plain_calls != res["tool_call_streamed"] \
            or res["tool_finish"] != ["tool_calls", "tool_calls"] \
            or any(name != "get_weather" or set(args) != {"city"}
                   or args["city"] not in ("Oslo", "Bergen") for name, args in plain_calls):
        fail(f"messages_infill_tools: the forced tool call: {res}")
    return counts


def model_bytes(torch, model) -> int:
    """A loaded model's parameter bytes on its device."""
    from zllm_torch.quant.repack import QWeight

    def leaf(v):
        if isinstance(v, QWeight):
            return v.nbytes
        return v.numel() * v.element_size() if isinstance(v, torch.Tensor) else 0

    params = model.params
    return sum(leaf(v) for k, v in params.items() if k != "layers") + sum(
        leaf(v) for layer in params["layers"] for v in layer.values())


def kv_bytes_of(engine) -> int:
    kv = engine.kv
    return sum(x.numel() * x.element_size() for name in ("k", "v", "ks", "vs")
               for x in getattr(kv, name, []))


ROUTER_MODELS = {"tinyllama_q4_k_m.gguf": ("tinyllama", "Q4_K_M"),
                 "olmo2_q4_k.gguf": ("olmo2", "Q4_K")}
ROUTER_SLACK = 0.05


def router_phase(torch, kernels: dict, card: str) -> dict:
    """`python -m zllm_torch.server --models-dir`'s router at full width:
    the TinyLlama Q4_K_M and OLMo-2 Q4_K files, models_max 1, requests
    alternating between them so that each loads the other out.  After
    every eviction torch.cuda.memory_allocated must be at most its value
    before the first load plus the resident model's bytes (parameters and
    KV), within ROUTER_SLACK; after the last unload, back to that value
    within ROUTER_SLACK of the larger model's bytes.  Then replicas 2 on one model: two engines over
    one loaded copy, requests alternating.  Launches held to the engines'
    counters."""
    import gc

    from zllm_torch.server.router import RouterServer

    t0 = time.perf_counter()
    folder = CACHE / "router_models"
    folder.mkdir(exist_ok=True)
    for name, (model, ftype) in ROUTER_MODELS.items():
        # made anew each run, relative, so it names this checkout's file
        link = folder / name
        link.unlink(missing_ok=True)
        target = gguf_file(model, main_shapes()[model][0], ftype)[0]
        link.symlink_to(os.path.relpath(target, folder))
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    zero_counts(kernels)
    expected = {name: 0 for name in kernels}

    def tally(inst, m0s):
        """Add the launches of inst's engines since m0s to `expected`."""
        cfg = inst.servers[0].model.cfg
        gemms = {"q4k_gemm": 4 * cfg.n_layers + 1} if cfg.arch == "olmo2" else None
        for s, m0 in zip(inst.servers, m0s):
            steps = {k: s.engine.metrics[k] - m0[k] for k in ENGINE_COUNTERS}
            for k, n in serve_expected(kernels, cfg, steps, gemms=gemms).items():
                expected[k] += n

    order = ["tinyllama_q4_k_m.gguf", "olmo2_q4_k.gguf", "tinyllama_q4_k_m.gguf",
             "olmo2_q4_k.gguf"]
    loads, texts = [], {}
    r = RouterServer(str(folder), port=0, models_max=1, n_slots=2, max_len=2048)
    r.start_background()
    try:
        listed = [m["id"] for m in json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{r.port}/v1/models", timeout=60).read())["data"]]
        for i, name in enumerate(order):
            t_req = time.perf_counter()
            out = json.loads(http_post(r.port, "/v1/completions", {
                "model": name, "prompt": letters(200 + i % 2, 100), "max_tokens": 8,
                "temperature": 0}))
            inst = r.instances[name]
            if list(r.instances) != [name]:
                fail(f"router: {list(r.instances)} loaded after a request to {name}")
            tally(inst, [dict.fromkeys(ENGINE_COUNTERS, 0)] * len(inst.servers))
            gc.collect()
            torch.cuda.synchronize()
            resident = model_bytes(torch, inst.servers[0].model) + sum(kv_bytes_of(s.engine)
                                                                for s in inst.servers)
            alloc = torch.cuda.memory_allocated()
            loads.append({"model": name, "evicted": order[i - 1] if i else None,
                          "allocated_over_base": alloc - base, "resident_bytes": resident,
                          "ratio": (alloc - base) / resident,
                          "request_s": time.perf_counter() - t_req})
            texts.setdefault(name, []).append(out["choices"][0]["text"])
        r.unload(order[-1])
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated() - base
    finally:
        r.shutdown()
    # replicas 2 on one model, round robin
    rr = RouterServer(str(folder), port=0, models_max=1, n_slots=2, max_len=2048, replicas=2)
    rr.start_background()
    try:
        inst = rr.load("tinyllama_q4_k_m.gguf")
        ports = [inst.pick().port for _ in range(4)]
        for i in range(4):
            http_post(rr.port, "/v1/completions", {"model": "tinyllama_q4_k_m.gguf",
                                                   "prompt": letters(300 + i, 60),
                                                   "max_tokens": 4, "temperature": 0})
        per_engine = [s.engine.metrics["requests_total"] for s in inst.servers]
        tally(inst, [dict.fromkeys(ENGINE_COUNTERS, 0)] * 2)
    finally:
        rr.shutdown()
    counts = engine_counts_check(torch, "router", kernels, expected, False)
    res = {"phase": "router", "models": listed, "models_max": 1, "loads": loads,
           "allocated_over_base_after_last_unload": after, "slack": ROUTER_SLACK,
           "same_text_on_reload": {n: len(set(t)) == 1 for n, t in texts.items()},
           "replicas": 2, "replica_ports": ports, "requests_per_replica": per_engine,
           "launches": counts, "seconds": time.perf_counter() - t0, "card": card}
    emit(res)
    if listed != sorted(ROUTER_MODELS):
        fail(f"router: lists {listed}")
    # the first load may also leave one-time allocations (it is not
    # after an eviction); every later one must fit the resident model
    if any(ld["ratio"] > 1 + ROUTER_SLACK for ld in loads[1:]) or after > ROUTER_SLACK * max(
            ld["resident_bytes"] for ld in loads):
        fail(f"router: the card's memory did not come back after an eviction: {res}")
    if len(set(ports)) != 2 or per_engine != [2, 2]:
        fail(f"router: replicas did not alternate: {res}")
    return counts


PROMPT_CACHE_IDS = 257  # one 256-token chunk, then the last token alone at column 0


def prompt_cache_phase(card: str) -> dict:
    """`python -m zllm_torch.cli MODEL -f P --prompt-cache F` twice on the
    card (the TinyLlama Q4_K_M file, 16 greedy tokens): the second run
    must report the reused prefix (all but the prompt's last token) and
    print the first run's text."""
    import re

    path, _ = gguf_file("tinyllama", main_shapes()["tinyllama"][0], "Q4_K_M")
    prompt = CACHE / "prompt_cache.txt"
    prompt.write_text(letters(7, PROMPT_CACHE_IDS - 1), encoding="utf-8")
    session = CACHE / "prompt_cache.session"
    session.unlink(missing_ok=True)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "zllm_torch.cli", str(path), "-f", str(prompt),
                              "-n", "16", "--greedy", "--prompt-cache", str(session)],
                             cwd=REPO, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            fail(f"prompt_cache: zllm_torch.cli failed: {out.stderr[-2000:]}")
        got = re.search(r"\[prompt cache: reused (\d+) tokens\]", out.stderr)
        runs.append({"stdout": out.stdout, "reused": int(got.group(1)) if got else 0,
                     "stats": out.stderr.strip().splitlines()[-1],
                     "seconds": time.perf_counter() - t0})
    res = {"phase": "prompt_cache", "model": "tinyllama-geometry Q4_K_M (random weights, seed 0)",
           "prompt_ids": PROMPT_CACHE_IDS, "session_bytes": os.path.getsize(session),
           "runs": runs, "same_text": runs[0]["stdout"] == runs[1]["stdout"], "card": card}
    emit(res)
    if runs[0]["reused"] or runs[1]["reused"] != PROMPT_CACHE_IDS - 1 or not res["same_text"]:
        fail(f"prompt_cache: {res}")
    return res


def switches_phase(torch, model, kernels: dict, card: str) -> dict:
    """The engine's switches at full width (paged bf16, 4 slots):
    prefix_reuse=False under shared-prefix traffic reuses nothing;
    context_shift=False finishes a request at max_len with "length" and
    no shift.  Launches held to the counters."""
    from zllm_torch.server.engine import Engine, Request

    t0 = time.perf_counter()
    zero_counts(kernels)
    expected = {name: 0 for name in kernels}
    prefix = model.tokenizer.encode(letters(11, 300), add_special=True)
    out = {}
    for switch, kw, waves in (
            ("prefix_reuse", dict(prefix_reuse=False),
             [[prefix + [100]], [prefix + [101], prefix + [102]]]),
            ("context_shift", dict(context_shift=False, max_len=256), [[prefix[:200]]])):
        eng = Engine(model, **kw)
        eng.start()
        try:
            got = []
            for wave in waves:
                reqs = eng.run_in_loop(lambda wave=wave: [eng.submit(Request(
                    prompt_tokens=p, max_new=100 if switch == "context_shift" else 8, temp=0.0))
                    for p in wave])
                wait_done(reqs)
                got += [(len(q.out_tokens), q.finish_reason, q.n_prompt_reused, q.error)
                        for q in reqs]
        finally:
            eng.stop()
        steps = {k: eng.metrics[k] for k in ENGINE_COUNTERS}
        for k, n in serve_expected(kernels, model.cfg, steps).items():
            expected[k] += n
        out[switch] = {"requests": got, "engine_counters": steps, "max_len": eng.max_len}
    counts = engine_counts_check(torch, "switches", kernels, expected, False)
    res = {"phase": "switches", "model": "tinyllama-geometry Q4_K_M (random weights, seed 0)",
           **out, "launches": counts, "seconds": time.perf_counter() - t0, "card": card}
    emit(res)
    pr, cs = out["prefix_reuse"], out["context_shift"]
    if pr["engine_counters"]["tokens_prefix_reused_total"] or any(g[2] for g in pr["requests"]):
        fail(f"switches: prefix_reuse=False reused a prefix: {res}")
    if cs["engine_counters"]["context_shifts_total"] or cs["requests"][0][:2] != (256 - 200,
                                                                                  "length"):
        fail(f"switches: context_shift=False did not finish at max_len: {res}")
    if any(g[3] for g in pr["requests"] + cs["requests"]):
        fail(f"switches: engine errors {res}")
    return counts


def qwen_step_phase(torch, name: str, model, step_ms: float, card: str) -> dict:
    """A Qwen main path's kernels at its own shapes (random inputs, seed 0),
    each beside its bound: one B = 1 decode step's matvecs through K1 (and
    K4: the Q4_K_M file's wv and first half of ffn_down), its attention
    blocks through K2 (Qwen3's with the per-head q/k norms) at the last
    decode position beside SDPA on the same caches, the tied bf16 head as
    the step runs it (`linear` on an f32 row: the weight cast to f32, then
    the product; beside it the product in bf16; its share of
    `step_graph_ms`), and one 256-row chunk's GEMMs through K3 (and K5);
    K1, K4, K3 and K5 checked against their plain versions on one call of
    each (fuse, K), K2 on the first layer.  Returns the phase's line."""
    import torch.nn.functional as F

    from zllm_torch.gguf.constants import GGMLType
    from zllm_torch.ops import attention as att
    from zllm_torch.ops import qmatmul as qmm
    from zllm_torch.ops.layers import rope_apply_table, rope_table
    from zllm_torch.ops.linear import linear

    cfg, layers = model.cfg, model.params["layers"]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def randn(*shape_, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape_, generator=g, device="cuda") * scale).to(dtype)

    def n_real(w):
        return w.shape[1]

    def first_of_each(calls, key):  # one call of each kind, for the plain check
        seen = {}
        for i, c in enumerate(calls):
            seen.setdefault(key(c), i)
        return tuple(seen.values())

    d, ff, eps = cfg.n_embd, cfg.n_ff, cfg.norm_eps
    x_res, x_att, x_gup = randn(1, d, scale=3.0), randn(1, cfg.q_dim), randn(1, 2 * ff)
    x_h = randn(1, d, dtype=torch.bfloat16)  # a normed row in the model dtype
    mv = {GGMLType.Q4_K: [], GGMLType.Q6_K: []}
    m_rows = CHUNK
    xs = {k: randn(m_rows, k) for k in {d, ff, cfg.q_dim}}
    xh = randn(m_rows, d, dtype=torch.bfloat16)
    gm = {GGMLType.Q4_K: [], GGMLType.Q6_K: []}
    for layer in layers:
        qkv = ([(x_res, layer["wqkv"], "norm", layer["attn_norm"])] if "wqkv" in layer
               else [(x_h, layer[k], "q", None) for k in ("wq", "wk", "wv")])
        for c in qkv + [(x_att, layer["wo"], "q", None),
                        (x_res, layer["ffn_gateup"], "norm", layer["ffn_norm"]),
                        (x_gup, layer["ffn_down"], "glu", None)]:
            mv[c[1].fmt].append(c)
        rows = ([(xh, layer["wqkv"])] if "wqkv" in layer
                else [(xh, layer[k]) for k in ("wq", "wk", "wv")])
        for x, w in rows + [(xs[cfg.q_dim], layer["wo"]), (xh, layer["ffn_gateup"]),
                            (xs[ff], layer["ffn_down"])]:
            gm[w.fmt].append((x, w))
    out = {"phase": "qwen_step", "model": name, "card": card, "step_graph_ms": step_ms}
    for fmt, fn, plain, gfn, gplain, key in (
            (GGMLType.Q4_K, qmm.q4k_matvec, qmm.q4k_matvec_plain, qmm.q4k_gemm,
             qmm.q4k_gemm_plain, "k1"),
            (GGMLType.Q6_K, qmm.int8_matvec, qmm.int8_matvec_plain, qmm.dequant_gemm,
             qmm.dequant_gemm_plain, "k4")):
        if not mv[fmt]:
            continue
        bpw = GGUF_BYTES_PER_WEIGHT[fmt.name]
        out[key] = dict(matvec_phase(torch, fn, plain, mv[fmt], n_real, bpw, eps,
                                     check=first_of_each(mv[fmt], lambda c: (c[2], c[1].shape[0]))),
                        launches=len(mv[fmt]), tolerance=1e-6,
                        k_widths=sorted({c[1].shape[0] for c in mv[fmt]}))
        out["k3" if key == "k1" else "k5"] = dict(
            gemm_phase(torch, gfn, gplain, gm[fmt], n_real, bpw,
                       check=first_of_each(gm[fmt], lambda c: c[1].shape)),
            launches=len(gm[fmt]), m=m_rows, tolerance=1e-6)

    # K2: the step's attention blocks over bf16 caches at the last position
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos_v = PROMPT_TOKENS + NEW_TOKENS - 1
    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    rope = rope_table(pos, cfg.rope, hd)
    qkv3 = randn(1, hq + 2 * hkv, hd)
    caches = [(randn(1, hkv, MAX_LEN, hd, dtype=torch.bfloat16),
               randn(1, hkv, MAX_LEN, hd, dtype=torch.bfloat16)) for _ in layers]
    norms = [(layer.get("attn_q_norm"), layer.get("attn_k_norm")) for layer in layers]
    scale = 1.0 / hd ** 0.5
    k2a, k2b = (tuple(t.clone() for t in caches[0]) for _ in range(2))
    a = att.attn_decode_qkv(qkv3, *k2a, pos, rope, *norms[0], scale=scale, eps=eps)
    b = att.attn_decode_qkv_plain(qkv3, *k2b, pos, rope, *norms[0], scale=scale, eps=eps)
    if not (torch.equal(k2a[1], k2b[1]) and nmse(k2a[0].float(), k2b[0].float()) <= 1e-9):
        fail(f"{name}: K2's new cache row differs from its plain version's")

    def k2(fn):
        def go():
            for (kc, vc), (qw, kw) in zip(caches, norms):
                fn(qkv3, kc, vc, pos, rope, qw, kw, scale=scale, eps=eps)
        return go

    # the yardstick: SDPA on the caches, q roped and rounded outside the
    # timing (attention only: no per-head norms, no insert)
    qr = rope_apply_table(qkv3[:, :hq].float(), rope).to(torch.bfloat16)[:, :, None]
    mask = (torch.arange(MAX_LEN, device="cuda") <= pos_v).reshape(1, 1, 1, MAX_LEN)

    def sdpa():
        for kc, vc in caches:
            F.scaled_dot_product_attention(qr, kc, vc, attn_mask=mask, scale=scale,
                                           enable_gqa=True)

    L = len(layers)
    nbytes = L * (2 * hkv * (pos_v + 1) * hd * 2 + qkv3.numel() * 4 + hq * hd * 4)
    bms, bby = bound_ms(nbytes, L * 4 * hq * (pos_v + 1) * hd, "bf16")
    out["k2"] = dict(ms=cuda_ms(k2(att.attn_decode_qkv), 20),
                     plain_ms=cuda_ms(k2(att.attn_decode_qkv_plain), 2), bound_ms=bms,
                     bound_by=bby, library_ms=cuda_ms(sdpa, 20),
                     library="scaled_dot_product_attention on the caches, q roped outside the "
                             "timing (attention only)", nmse=nmse(a.float(), b.float()),
                     max_abs_err=float((a.float() - b.float()).abs().max()), tolerance=1e-5,
                     launches=L, qk_norms=norms[0][0] is not None,
                     shapes=f"qkv3 [1,{hq + 2 * hkv},{hd}] f32, cache [1,{hkv},{MAX_LEN},{hd}] "
                            f"bf16, pos {pos_v}, G {hq // hkv}")
    del caches
    # the tied head: a dense bf16 [n_embd, vocab] weight, as zllm has it,
    # given the f32 row the step gives it (the kernels return f32, so the
    # residual stream is f32): `linear` casts the weight to f32 first, as
    # zllm's `w.astype(x.dtype)` does; `bf16_ms` the product in bf16
    head = model.params["output"]
    xh32 = randn(1, d)
    xb = xh32.to(torch.bfloat16)
    hbytes = head.numel() * head.element_size()
    out["head"] = dict(ms=cuda_ms(lambda: linear(xh32, head), 20),
                       bf16_ms=cuda_ms(lambda: torch.matmul(xb, head), 20),
                       bound_ms=hbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                       bytes=hbytes, shape=list(head.shape), dtype=str(head.dtype)[6:])
    out["head"]["share_of_step"] = out["head"]["ms"] / step_ms
    emit(out)
    bad = [k for k in ("k1", "k4", "k2", "k3", "k5") if k in out
           and not out[k]["nmse"] <= out[k]["tolerance"]]
    if bad:
        fail(f"{name}: kernels disagree with their plain versions at the model's shapes: {bad}")
    return out


# the importance-matrix slice: `zllm_torch.imatrix`'s collection over the
# TinyLlama Q8_0 file (IMATRIX_CHUNKS chunks of IMATRIX_CTX tokens,
# IMATRIX_BATCH a forward: K5 at M = 1024 and K6 with no cache), then
# `zllm_torch.quantize --imatrix` of the TinyLlama F16 file to IQ2_XXS
# with the grid fit on the card, and that file's generate
IMATRIX_CTX, IMATRIX_CHUNKS, IMATRIX_BATCH = 512, 8, 2
# the plain versions' collection over the first forward's chunks (full
# depth), each tensor's sums held to the nmse the GPU-vs-CPU logits rows
# are held to (the stream's bf16 and f32-to-bf16 roundings carry an f32
# sum-order difference on through the layers)
IMATRIX_PLAIN_CHUNKS, IMATRIX_PLAIN_NMSE = 2, 1e-4
# the card's grid fit against the CPU's on the first rows of a full-width
# matrix: the share of equal 256-blocks it must reach (the products' sum
# order may part a near-tie)
IQ_FIT_ROWS, IQ_FIT_MIN_SHARE = 64, 0.99


def imatrix_corpus(tok, n: int) -> list[int]:
    """The first n ids of a text of words drawn from a seeded generator
    (the byte-level vocab: about a token a byte)."""
    words = ("the model reads every weight once while the card counts bytes and a quiet "
             "river runs past seven old mills under grey autumn skies").split()
    rng = random.Random(0)
    ids = tok.encode(" ".join(rng.choice(words) for _ in range(2 * n)), add_special=True)
    if len(ids) < n:
        fail(f"the imatrix corpus tokenized to {len(ids)} ids, wanted {n}")
    return ids[:n]


def imatrix_phase(torch, kernels: dict, card: str):
    """Collect the importance matrix of the TinyLlama Q8_0 model on the card
    (`collect_imatrix`, `write_imatrix`: what `python -m zllm_torch.imatrix`
    runs), the launch counters set to 0 just before and read just after;
    then the first forward's chunks once more through the plain versions
    of K5 and K6 on the card.  Returns the model, the corpus's ids, the
    imatrix file, the counts and the collection's seconds."""
    import numpy as np

    from zllm_torch import imatrix as ti
    from zllm_torch.models import llama
    from zllm_torch.models.loader import Model
    from zllm_torch.ops import attention as att
    from zllm_torch.ops import qmatmul as qmm

    shape, label = main_shapes()["tinyllama"]
    path, t_gguf = gguf_file("tinyllama", shape, "Q8_0")
    t0 = time.perf_counter()
    model = Model.load(str(path), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    ids = imatrix_corpus(model.tokenizer, IMATRIX_CHUNKS * IMATRIX_CTX)
    ti.collect_imatrix(model, ids[:IMATRIX_CTX], IMATRIX_CTX, 1)  # warm-up
    k6 = kernels["flash_attention"]
    for fn in kernels.values():
        fn.launches = 0
    k6.mma_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums, counts = ti.collect_imatrix(model, ids, IMATRIX_CTX, IMATRIX_BATCH)
    t_collect = time.perf_counter() - t0
    launched = {name: fn.launches for name, fn in kernels.items()}
    k6_mma = k6.mma_launches  # 0: with no cache K/V stay f32 (K5's output), the tile form
    im_path = CACHE / "tinyllama_q8_0.imatrix.gguf"
    ti.write_imatrix(str(im_path), str(path), sums, counts, n_ctx=IMATRIX_CTX)
    L = model.cfg.n_layers
    forwards = -(-IMATRIX_CHUNKS // IMATRIX_BATCH)
    expected = dict({name: 0 for name in kernels}, dequant_gemm=(4 * L + 1) * forwards,
                    flash_attention=L * forwards)

    # the plain versions on the card: the first forward's chunks, full depth
    first = ids[:IMATRIX_PLAIN_CHUNKS * IMATRIX_CTX]
    with torch.inference_mode():
        kern, _ = ti.collect_imatrix(model, first, IMATRIX_CTX, IMATRIX_BATCH)
        t0 = time.perf_counter()
        with mock.patch.object(qmm, "dequant_gemm", qmm.dequant_gemm_plain), \
                mock.patch.object(llama, "flash_attention", att.flash_attention_plain):
            plain, _ = ti.collect_imatrix(model, first, IMATRIX_CTX, IMATRIX_BATCH)
        t_plain = time.perf_counter() - t0
    errs = {name: nmse(torch.from_numpy(kern[name]), torch.from_numpy(plain[name]))
            for name in plain}
    worst = max(errs, key=errs.get)
    col_rel = max(float(np.max(np.abs(kern[n] - plain[n]) / np.maximum(plain[n], 1e-30)))
                  for n in plain)
    back = ti.read_imatrix(str(im_path))
    res = {"phase": "imatrix", "model": f"{label} Q8_0 (random weights, seed 0)",
           "shape": shape, "dtype": "bfloat16", "chunks": IMATRIX_CHUNKS, "ctx": IMATRIX_CTX,
           "batch": IMATRIX_BATCH, "forwards": forwards, "tensors": len(sums),
           "gguf_build_s": t_gguf, "load_s": t_load, "collect_s": t_collect,
           "tokens_per_s": IMATRIX_CHUNKS * IMATRIX_CTX / t_collect,
           "launches": launched, "launches_expected": expected,
           "flash_attention_mma_launches": k6_mma,
           "plain_chunks": IMATRIX_PLAIN_CHUNKS, "plain_s": t_plain,
           "plain_nmse_max": errs[worst], "plain_worst_tensor": worst,
           "plain_column_max_rel_diff": col_rel, "plain_nmse_tolerance": IMATRIX_PLAIN_NMSE,
           "card": card}
    emit(res)
    if launched != expected:
        fail(f"imatrix: kernel launch counts {launched} != expected {expected}")
    if set(sums) != set(back) or len(sums) != 5 * L + 1:
        fail(f"imatrix: {len(sums)} tensors collected, {len(back)} read back, want {5 * L + 1}")
    if not all(np.all(np.isfinite(v)) and np.all(v > 0) for v in back.values()):
        fail("imatrix: a read-back mean square is not finite and positive")
    if not errs[worst] <= IMATRIX_PLAIN_NMSE:
        fail(f"imatrix: sums differ from the plain versions' by nmse {errs[worst]} ({worst})")
    return model, ids, im_path, launched, t_collect


def kernel_imatrix(torch, model, ids: list, card: str) -> dict:
    """K5 over the 89 Q8_0 GEMMs of an imatrix forward (M = batch x ctx; x
    bf16 in layer 0's first, f32 after the first residual) by weight role
    and K6 over its 22 attentions (f32 q and K/V: no cache, so the tile
    form), the very calls a forward makes (recorded, then replayed), each
    against its plain version, timed beside its bound and the library
    call."""
    import torch.nn.functional as F

    from zllm_torch import imatrix as ti
    from zllm_torch.models import llama
    from zllm_torch.ops import attention as att
    from zllm_torch.ops import qmatmul as qmm

    cfg = model.cfg
    calls, acalls = [], []
    real_g, real_a = qmm.gemm, att.flash_attention

    def spy_g(x, w):  # every matmul of the forward is a Q8_0 GEMM: K5
        calls.append((x, w))
        return real_g(x, w)

    def spy_a(q, k, v, positions, **kw):
        acalls.append((q, k, v, positions, kw))
        return real_a(q, k, v, positions, **kw)

    with mock.patch.object(qmm, "gemm", spy_g), \
            mock.patch.object(llama, "flash_attention", spy_a):
        ti.collect_imatrix(model, ids[:IMATRIX_BATCH * IMATRIX_CTX], IMATRIX_CTX, IMATRIX_BATCH)
    roles = {role: list(range(i, len(calls) - 1, 4))
             for i, role in enumerate(("wqkv", "wo", "gate_up", "down"))}
    roles["head"] = [len(calls) - 1]
    n_real = {id(model.params["output"]): cfg.vocab_size}
    k5 = gemm_phase(torch, qmm.dequant_gemm, qmm.dequant_gemm_plain, calls,
                    lambda w: n_real.get(id(w), w.shape[1]), GGUF_BYTES_PER_WEIGHT["Q8_0"],
                    check=(0, 1, 2, 3, 4, len(calls) - 1), groups=roles)
    q, k, v, pos, kw = acalls[0]
    a, p = att.flash_attention(q, k, v, pos, **kw), att.flash_attention_plain(q, k, v, pos, **kw)

    def run(fn):
        def go():
            for q_, k_, v_, pos_, kw_ in acalls:
                fn(q_, k_, v_, pos_, **kw_)
        return go

    def lib():
        for q_, k_, v_, _, kw_ in acalls:
            F.scaled_dot_product_attention(q_.transpose(1, 2), k_, v_, is_causal=True,
                                           enable_gqa=True, scale=kw_["scale"])

    b, t, hq, d = q.shape
    pairs = b * t * (t + 1) // 2  # causal, S = T from position 0
    bms, bby = bound_ms(len(acalls) * (2 * q.numel() + 2 * k.numel()) * q.element_size(),
                        len(acalls) * 4 * hq * d * pairs, "bf16")
    k6 = dict(ms=cuda_ms(run(att.flash_attention), 10),
              plain_ms=cuda_ms(run(att.flash_attention_plain), 2), library_ms=cuda_ms(lib, 10),
              bound_ms=bms, bound_by=bby, nmse=nmse(a, p), tolerance=1e-5,
              max_abs_err=float((a - p).abs().max()), launches=len(acalls),
              shapes=f"q {list(q.shape)} {str(q.dtype)[6:]}, k/v {list(k.shape)} "
                     f"{str(k.dtype)[6:]} (no cache), {len(acalls)} layers")
    res = {"phase": "kernel_imatrix", "card": card,
           "dequant_gemm": dict(k5, tolerance=1e-6, launches=len(calls),
                                x_dtypes=sorted({str(x.dtype)[6:] for x, _ in calls}),
                                shapes=f"M = {calls[0][0].shape[0]}, the TinyLlama Q8_0 weights"),
           "flash_attention": k6,
           "note": "one imatrix forward's own K5 GEMMs (Q8_0, by weight role) and K6 "
                   "attentions, recorded and replayed; bound: weight and activation bytes over "
                   "3.35 TB/s or 2*M*K*N (K6: 4*Hq*D a causal pair) over 989 TFLOP/s; "
                   "library: torch.matmul on the bf16-dequantized weights, "
                   "scaled_dot_product_attention (is_causal, the same f32 q/k/v)"}
    emit(res)
    if not (k5["nmse"] <= 1e-6 and k6["nmse"] <= 1e-5):
        fail(f"kernel_imatrix: K5 nmse {k5['nmse']}, K6 nmse {k6['nmse']}")
    return res


def quantize_imatrix_phase(torch, kernels: dict, card: str, im_path: Path, want) -> dict:
    """`zllm_torch.quantize --imatrix` of the TinyLlama F16 file to IQ2_XXS
    with the grid fit on the card; each IQ type's encode of one full-width
    matrix (blk.0.ffn_gate) on the card, timed, its weighted error against
    the unweighted encode's, and its first rows against the CPU fit's; then
    the written file's generate (main_path, `want` its counts)."""
    import numpy as np

    from zllm_torch import quantize as tq
    from zllm_torch.gguf.constants import GGML_BLOCK_SIZES, GGMLType
    from zllm_torch.gguf.reader import read_gguf
    from zllm_torch.imatrix import read_imatrix
    from zllm_torch.models.loader import Model
    from zllm_torch.quant import blocks as qb

    shape, label = main_shapes()["tinyllama"]
    src = f16_file("tinyllama", shape)
    imatrix = read_imatrix(str(im_path))
    dst = CACHE / "tinyllama_iq2_xxs_imatrix.gguf"
    t0 = time.perf_counter()
    stats = tq.quantize_file(str(src), str(dst), "IQ2_XXS", imatrix, quiet=True, device="cuda")
    t_quant = time.perf_counter() - t0
    fmts = {}
    for _, t_, _ in stats.values():
        fmts[t_] = fmts.get(t_, 0) + 1
    weighted = sorted(n for n in stats if n in imatrix)
    name = "blk.0.ffn_gate.weight"
    with read_gguf(str(src)) as f:
        x = f.tensor_f32(name)
    w = imatrix[name]
    per_type = {}
    for ftype in IQ_FTYPES:
        t = GGMLType[ftype]
        t0 = time.perf_counter()
        raw = qb.quantize(x, t, weights=w, device="cuda")
        secs = time.perf_counter() - t0
        plain = qb.quantize(x, t, device="cuda")
        cpu = qb.quantize(x[:IQ_FIT_ROWS], t, weights=w, device="cpu")
        bsz = GGML_BLOCK_SIZES[t][1]
        share = float((raw[:IQ_FIT_ROWS].reshape(-1, bsz) == cpu.reshape(-1, bsz)).all(1).mean())

        def werr(r):
            dec = qb.dequantize(r, t).reshape(x.shape).astype(np.float64)
            return float((w * (dec - x) ** 2).sum())

        t0 = time.perf_counter()  # the host's share of quantize_file: decode, statistics
        tq._weighted_rmse(qb.dequantize(raw, t).reshape(x.shape), x, w)
        stats_s = time.perf_counter() - t0
        per_type[ftype] = dict(card_s=secs, stats_s=stats_s, weighted_err=werr(raw),
                               unweighted_err=werr(plain), cpu_rows=IQ_FIT_ROWS,
                               equal_block_share=share)
        per_type[ftype]["ratio"] = per_type[ftype]["weighted_err"] / per_type[ftype][
            "unweighted_err"]
    res = {"phase": "quantize_imatrix", "model": f"{label} F16 (random weights, seed 0)",
           "ftype": "IQ2_XXS", "imatrix_tensors": len(imatrix), "quantize_s": t_quant,
           "types": fmts, "weighted_tensors": len(weighted),
           "weighted_rmse_mean": float(np.mean([stats[n][2] for n in weighted])),
           "matrix": f"{name} {tuple(x.shape)}", "per_type": per_type,
           "min_equal_block_share": IQ_FIT_MIN_SHARE, "card": card}
    emit(res)
    bad = {k: v for k, v in per_type.items()
           if not (v["equal_block_share"] >= IQ_FIT_MIN_SHARE and v["ratio"] <= 1.001)}
    if bad:
        fail(f"quantize_imatrix: the card's fit parts from the CPU's or the imatrix does not "
             f"lower the weighted error: {bad}")
    L = shape["n_layers"]  # IQ2_XXS: q, k, o, gate, up, down; weighted: the four tapped
    if fmts.get("IQ2_XXS") != 6 * L or len(weighted) != 4 * L:
        fail(f"quantize_imatrix: types {fmts}, {len(weighted)} weighted tensors")
    model = Model.load(str(dst), device="cuda", dtype=torch.bfloat16)
    _, counts, gen, *_ = main_path(torch, "IQ2_XXS (imatrix)", kernels, want, card,
                                   new_tokens=IQ_SHORT_TOKENS, model=model)
    del gen
    return dict(counts=counts, quantize_s=t_quant, per_type=per_type)


def tokenizer_roundtrip(card: str):
    """The BPE pretokenizers and merges on this host (which may lack
    `regex`): the pinned text's ids for each pre, beside the ids the CPU
    tests hold equal to zllm's."""
    import importlib.util

    from zllm_torch.testing import BPE_ROUNDTRIP_IDS, BPE_ROUNDTRIP_TEXT, synthetic_bpe_vocab
    from zllm_torch.tokenizer import Tokenizer

    ids, same = {}, {}
    for pre, pinned in BPE_ROUNDTRIP_IDS.items():
        tok = Tokenizer(synthetic_bpe_vocab(pre, 4096))
        ids[pre] = tok.encode(BPE_ROUNDTRIP_TEXT, add_special=True, parse_special=True)
        same[pre] = ids[pre] == pinned and tok.decode(ids[pre]) == BPE_ROUNDTRIP_TEXT.replace(
            "<|im_start|>", "")
    emit({"phase": "tokenizer_roundtrip", "text": BPE_ROUNDTRIP_TEXT,
          "regex_importable": importlib.util.find_spec("regex") is not None, "ids": ids,
          "pinned_ids": BPE_ROUNDTRIP_IDS, "equal": same, "card": card})
    if not all(same.values()):
        fail(f"BPE ids differ from the pinned ones: {same}")


# the GGUF blocks of the formats whose kernel forms predate the IQ grid
# slice: (weights a block, block bytes, offsets of the fp16 scales); the
# nibble formats go to K1/K3, the others to K4/K5 (MXFP4: its exponent byte
# at 0, drawn from [115, 135))
def _paged_table(torch, n_slots: int, lp: int, seed: int):
    """A page table [n_slots, lp + 1] of scrambled pages 1 .. n_slots * lp
    (physical != logical), the last column pinned to the trash page 0."""
    perm = torch.randperm(n_slots * lp, generator=torch.Generator().manual_seed(seed)) + 1
    table = torch.zeros((n_slots, lp + 1), dtype=torch.int32)
    table[:, :lp] = perm.reshape(n_slots, lp).to(torch.int32)
    return table.to("cuda")


def kernel_f16_phase(torch, F, cfg, cfg_q3, cfg_q25, cfg_o, card: str, step_ms: dict) -> dict:
    """The f16 forms of K2, K6, K8, K9 and K10 against their plain versions
    on the card, at the shapes of their bf16 rows in the `kernel` lines
    (TinyLlama geometry `cfg`): K8 at an OLMo-2-0425-1B decode step
    (`cfg_o`: 16 layers, 16 / 16 heads of 128, pos 331) and at a TinyLlama
    contiguous engine step (B 4, S 2176, G 8, a trash row at 2048); K2 at a
    decode step (22 layers, pos 331),
    at a contiguous engine step (B 4, S 2176, a trash row) and in the
    per-head q/k-norm form at Qwen3-1.7B's heads (`cfg_q3`: 28 layers, 16 /
    8 of 128); K6 at a prefill chunk (the second, from 256); K9 at a serve
    decode step and K10 at a serve mixed step (4 slots, 16 pages of 128, a
    scrambled table, rows at 255, 0, 300 and a trash row; chunk 128 from 0,
    256, 300); and K9 and K10 at Qwen2.5-1.5B's heads (`cfg_q25`: 28
    layers, 12 / 2 of 128) in bf16 and in f16.  Each: device ms from
    CUDA-graph replay over the step's layers, the plain version's, SDPA's
    on the same f16 K/V (q cast to f16, roped outside the timing for K2),
    the bound (the bf16 rows' bytes and operations: an f16 element is two
    bytes too), and nmse and max |error| against the plain version with an
    f32 q (the paths' dtype) and with a bf16 q; the caches or pools after
    the insert against the plain version's.  `step_ms`: the f16 and bf16
    Q4_K_M decode steps' `step_graph_ms` (and the OLMo-2 Q4_K ones).  Returns
    the phase's line."""
    from zllm_torch.ops import attention as att
    from zllm_torch.ops.layers import rope_apply_table, rope_table

    g = torch.Generator(device="cuda")
    g.manual_seed(16)
    f16, bf16 = torch.float16, torch.bfloat16

    def randn(*shape_, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape_, generator=g, device="cuda") * scale).to(dtype)

    def agree(a, b):
        a, b = a.float(), b.float()
        return dict(nmse=nmse(a, b), max_abs_err=float((a - b).abs().max()))

    def k2_case(n_layers, b, hq, hkv, d, s, pos_vals, rope_p, eps, norms=False, cdtype=f16):
        qkv3 = randn(b, hq + 2 * hkv, d)
        kcs = [randn(b, hkv, s, d, dtype=cdtype) for _ in range(n_layers)]
        vcs = [randn(b, hkv, s, d, dtype=cdtype) for _ in range(n_layers)]
        pos = torch.tensor(pos_vals, dtype=torch.int32, device="cuda")
        rope = rope_table(pos, rope_p, d)
        qw, kw = (randn(d, scale=0.1) + 1.0, randn(d, scale=0.1) + 1.0) if norms else (None, None)
        kw_ = dict(scale=d ** -0.5, eps=eps)
        chk = {}
        for qn, qd in (("f32_q", torch.float32), ("bf16_q", bf16)):
            ka, va, kb, vb = (x.clone() for x in (kcs[0], vcs[0], kcs[0], vcs[0]))
            a = att.attn_decode_qkv(qkv3.to(qd), ka, va, pos, rope, qw, kw, **kw_)
            b_ = att.attn_decode_qkv_plain(qkv3.to(qd), kb, vb, pos, rope, qw, kw, **kw_)
            chk[qn] = dict(agree(a, b_), v_cache_equal=bool(torch.equal(va, vb)),
                           k_cache_nmse=nmse(ka.float(), kb.float()))

        def run(fn):
            def go():
                for kc, vc in zip(kcs, vcs):
                    fn(qkv3, kc, vc, pos, rope, qw, kw, **kw_)
            return go

        qr = rope_apply_table(qkv3[:, :hq].float(), rope).to(cdtype)[:, :, None]
        mask = (torch.arange(s, device="cuda")[None, :] <= pos[:, None]).reshape(-1, 1, 1, s)

        def lib():
            for kc, vc in zip(kcs, vcs):
                F.scaled_dot_product_attention(qr, kc, vc, attn_mask=mask, scale=d ** -0.5,
                                               enable_gqa=True)

        seen = sum(min(p_ + 1, s) for p_ in pos_vals)
        nbytes = n_layers * (2 * hkv * seen * d * 2 + qkv3.numel() * 4 + b * hq * d * 4)
        bms, bby = bound_ms(nbytes, n_layers * 4 * hq * seen * d, "bf16")
        return dict(ms=cuda_ms(run(att.attn_decode_qkv), 20),
                    plain_ms=cuda_ms(run(att.attn_decode_qkv_plain), 2),
                    library_ms=cuda_ms(lib, 20), bound_ms=bms, bound_by=bby, **chk["f32_q"],
                    bf16_q=chk["bf16_q"], launches=n_layers,
                    shapes=f"qkv3 [{b},{hq + 2 * hkv},{d}] f32, cache [{b},{hkv},{s},{d}] "
                           f"{str(cdtype)[6:]}, pos {pos_vals}{', q/k norms' if norms else ''}, "
                           f"{n_layers} layers")

    def k8_case(n_layers, b, hq, hkv, d, s, pos_vals, cdtype=f16):
        pos = torch.tensor(pos_vals, dtype=torch.int32, device="cuda")[:, None]
        q, kn, vn = randn(b, 1, hq, d), randn(b, 1, hkv, d), randn(b, 1, hkv, d)
        kcs = [randn(b, hkv, s, d, dtype=cdtype) for _ in range(n_layers)]
        vcs = [randn(b, hkv, s, d, dtype=cdtype) for _ in range(n_layers)]
        kw_ = dict(scale=d ** -0.5)
        chk = {}
        for qn, qd in (("f32_q", torch.float32), ("bf16_q", bf16)):
            ka, va, kb, vb = (x.clone() for x in (kcs[0], vcs[0], kcs[0], vcs[0]))
            a = att.attn_decode_update(q.to(qd), kn.to(qd), vn.to(qd), ka, va, pos, **kw_)
            b_ = att.attn_decode_update_plain(q.to(qd), kn.to(qd), vn.to(qd), kb, vb, pos, **kw_)
            chk[qn] = dict(agree(a, b_),
                           caches_equal=bool(torch.equal(ka, kb) and torch.equal(va, vb)))

        def run(fn):
            def go():
                for kc, vc in zip(kcs, vcs):
                    fn(q, kn, vn, kc, vc, pos, **kw_)
            return go

        qh = q.to(cdtype).transpose(1, 2)
        mask = (torch.arange(s, device="cuda")[None, :] <= pos).reshape(b, 1, 1, s)

        def lib():  # SDPA on the caches the kernel already inserted into
            for kc, vc in zip(kcs, vcs):
                F.scaled_dot_product_attention(qh, kc, vc, attn_mask=mask, enable_gqa=True, **kw_)

        seen = sum(min(p_ + 1, s) for p_ in pos_vals)
        nbytes = n_layers * (2 * hkv * seen * d * 2 + (q.numel() + 2 * kn.numel()) * 4
                             + q.numel() * 4 + 2 * b * hkv * d * 2)
        bms, bby = bound_ms(nbytes, n_layers * 4 * hq * seen * d, "bf16")
        return dict(ms=cuda_ms(run(att.attn_decode_update), 20),
                    plain_ms=cuda_ms(run(att.attn_decode_update_plain), 2),
                    library_ms=cuda_ms(lib, 20), bound_ms=bms, bound_by=bby, **chk["f32_q"],
                    bf16_q=chk["bf16_q"], launches=n_layers,
                    shapes=f"q [{b},1,{hq},{d}] f32, k/v_new [{b},1,{hkv},{d}] f32, cache "
                           f"[{b},{hkv},{s},{d}] {str(cdtype)[6:]}, pos {pos_vals}, "
                           f"{n_layers} layers")

    def k6_case(n_layers, t, hq, hkv, d, s, starts, cdtype=f16):
        b = len(starts)
        pos = (torch.tensor(starts, dtype=torch.int32, device="cuda")[:, None]
               + torch.arange(t, dtype=torch.int32, device="cuda")[None])
        q = randn(b, t, hq, d)
        kvs = [(randn(b, hkv, s, d, dtype=cdtype), randn(b, hkv, s, d, dtype=cdtype))
               for _ in range(n_layers)]
        kw_ = dict(scale=d ** -0.5)
        chk = {qn: agree(att.flash_attention(q.to(qd), *kvs[0], pos, **kw_),
                         att.flash_attention_plain(q.to(qd), *kvs[0], pos, **kw_))
               for qn, qd in (("f32_q", torch.float32), ("bf16_q", bf16))}

        def run(fn):
            def go():
                for k_, v_ in kvs:
                    fn(q, k_, v_, pos, **kw_)
            return go

        qh = q.to(cdtype).transpose(1, 2)
        mask = (torch.arange(s, device="cuda")[None, None, :] <= pos[:, :, None]).reshape(
            b, 1, t, s)

        def lib():
            for k_, v_ in kvs:
                F.scaled_dot_product_attention(qh, k_, v_, attn_mask=mask, enable_gqa=True, **kw_)

        seen = sum(min(p_ + t - 1, s - 1) + 1 for p_ in starts)
        pairs = sum(min(p_ + i, s - 1) + 1 for p_ in starts for i in range(t))
        nbytes = n_layers * (2 * q.numel() * 4 + 2 * hkv * seen * d * 2)
        bms, bby = bound_ms(nbytes, n_layers * 4 * hq * d * pairs, "bf16")
        return dict(ms=cuda_ms(run(att.flash_attention), 10),
                    plain_ms=cuda_ms(run(att.flash_attention_plain), 2),
                    library_ms=cuda_ms(lib, 10), bound_ms=bms, bound_by=bby, **chk["f32_q"],
                    bf16_q=chk["bf16_q"], launches=n_layers,
                    shapes=f"q [{b},{t},{hq},{d}] f32 from {starts}, k/v [{b},{hkv},{s},{d}] "
                           f"{str(cdtype)[6:]}, {n_layers} layers")

    # the serving path's pages: 4 slots, 16 logical pages of 128, a scrambled table
    n_slots, ps, lp = 4, 128, MAX_LEN // 128
    horizon = lp * ps
    table = _paged_table(torch, n_slots, lp, 2)
    rows = (table[:, :lp].long()[:, torch.arange(horizon, device="cuda") // ps] * ps
            + torch.arange(horizon, device="cuda") % ps).reshape(-1)

    def gathered(pool, hkv, d):  # [B, Hkv, S, D] through the table (outside any timing)
        return pool[:, rows].reshape(hkv, n_slots, horizon, d).transpose(0, 1)

    def k9_case(n_layers, hq, hkv, d, cdtype=f16):
        pools = [(randn(hkv, (n_slots * lp + 1) * ps, d, dtype=cdtype),
                  randn(hkv, (n_slots * lp + 1) * ps, d, dtype=cdtype)) for _ in range(n_layers)]
        pos = torch.tensor([[255], [0], [300], [horizon]], dtype=torch.int32, device="cuda")
        q, kn, vn = randn(n_slots, 1, hq, d), randn(n_slots, 1, hkv, d), randn(n_slots, 1, hkv, d)
        kw_ = dict(page_size=ps, scale=d ** -0.5)
        live = pos[:, 0] < horizon
        chk = {}
        for qn, qd in (("f32_q", torch.float32), ("bf16_q", bf16)):
            ka, va, kb, vb = (x.clone() for x in (*pools[0], *pools[0]))
            a = att.paged_attn_decode_update(q.to(qd), kn.to(qd), vn.to(qd), ka, va, table, pos,
                                             **kw_)
            b_ = att.paged_attn_decode_update_plain(q.to(qd), kn.to(qd), vn.to(qd), kb, vb,
                                                    table, pos, **kw_)
            chk[qn] = dict(agree(a[live], b_[live]),
                           pools_equal=bool(torch.equal(ka, kb) and torch.equal(va, vb)))

        def run(fn):
            def go():
                for kp_, vp_ in pools:
                    fn(q, kn, vn, kp_, vp_, table, pos, **kw_)
            return go

        kg = [(gathered(kp_, hkv, d), gathered(vp_, hkv, d)) for kp_, vp_ in pools]
        qh = q.to(cdtype).transpose(1, 2)
        mask = (torch.arange(horizon, device="cuda")[None, :] <= pos).reshape(n_slots, 1, 1,
                                                                                horizon)

        def lib():
            for k_, v_ in kg:
                F.scaled_dot_product_attention(qh, k_, v_, attn_mask=mask, scale=d ** -0.5,
                                               enable_gqa=True)

        read = sum(min(int(p_), horizon - 1) + 1 for p_ in pos[:, 0].tolist())
        nbytes = n_layers * (2 * hkv * read * d * 2 + (q.numel() + 2 * kn.numel()) * 4
                             + q.numel() * 4 + 2 * int(live.sum()) * hkv * d * 2)
        bms, bby = bound_ms(nbytes, n_layers * 4 * hq * read * d, "bf16")
        out = dict(ms=cuda_ms(run(att.paged_attn_decode_update), 20),
                   plain_ms=cuda_ms(run(att.paged_attn_decode_update_plain), 2),
                   library_ms=cuda_ms(lib, 20), bound_ms=bms, bound_by=bby, **chk["f32_q"],
                   bf16_q=chk["bf16_q"], launches=n_layers,
                   shapes=f"q [{n_slots},1,{hq},{d}] f32, pools [{hkv},{(n_slots * lp + 1) * ps},"
                          f"{d}] {str(cdtype)[6:]}, table scrambled, pos "
                          f"{pos[:, 0].tolist()}, {n_layers} layers")
        del kg
        return out

    def k10_case(n_layers, hq, hkv, d, cdtype=f16):
        pools = [(randn(hkv, (n_slots * lp + 1) * ps, d, dtype=cdtype),
                  randn(hkv, (n_slots * lp + 1) * ps, d, dtype=cdtype)) for _ in range(n_layers)]
        t = 128
        pos = (torch.tensor([0, 256, 300, horizon], dtype=torch.int32, device="cuda")[:, None]
               + torch.arange(t, dtype=torch.int32, device="cuda")[None])
        q = randn(n_slots, t, hq, d)
        kw_ = dict(page_size=ps, scale=d ** -0.5)
        live = pos[:, 0] < horizon
        chk = {qn: agree(att.paged_attention(q.to(qd), *pools[0], table, pos, **kw_)[live],
                         att.paged_attention_plain(q.to(qd), *pools[0], table, pos, **kw_)[live])
               for qn, qd in (("f32_q", torch.float32), ("bf16_q", bf16))}

        def run(fn):
            def go():
                for kp_, vp_ in pools:
                    fn(q, kp_, vp_, table, pos, **kw_)
            return go

        kg = [(gathered(kp_, hkv, d), gathered(vp_, hkv, d)) for kp_, vp_ in pools]
        qh = q.to(cdtype).transpose(1, 2)
        mask = (torch.arange(horizon, device="cuda")[None, None, :] <= pos[:, :, None]).reshape(
            n_slots, 1, t, horizon)

        def lib():
            for k_, v_ in kg:
                F.scaled_dot_product_attention(qh, k_, v_, attn_mask=mask, scale=d ** -0.5,
                                               enable_gqa=True)

        reads = sum(min(int(p_) + t - 1, horizon - 1) + 1 for p_ in pos[:, 0].tolist())
        pairs = sum(min(int(p_) + i, horizon - 1) + 1 for p_ in pos[:, 0].tolist()
                    for i in range(t))
        nbytes = n_layers * (2 * q.numel() * 4 + 2 * hkv * reads * d * 2)
        bms, bby = bound_ms(nbytes, n_layers * 4 * hq * pairs * d, "bf16")
        out = dict(ms=cuda_ms(run(att.paged_attention), 10),
                   plain_ms=cuda_ms(run(att.paged_attention_plain), 2),
                   library_ms=cuda_ms(lib, 10), bound_ms=bms, bound_by=bby, **chk["f32_q"],
                   bf16_q=chk["bf16_q"], launches=n_layers,
                   shapes=f"q [{n_slots},{t},{hq},{d}] f32 from {pos[:, 0].tolist()}, pools "
                          f"[{hkv},{(n_slots * lp + 1) * ps},{d}] {str(cdtype)[6:]}, table "
                          f"scrambled, {n_layers} layers")
        del kg
        return out

    L, hq, hkv, d = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos_step = PROMPT_TOKENS + NEW_TOKENS - 1
    q25 = (cfg_q25.n_layers, cfg_q25.n_heads, cfg_q25.n_kv_heads, cfg_q25.head_dim)
    before16 = f16_counts({n: getattr(att, n) for n in (
        "attn_decode_qkv", "attn_decode_update", "flash_attention", "paged_attn_decode_update",
        "paged_attention")})
    forms = {
        "attn_decode_update": {
            "olmo2_step": k8_case(cfg_o.n_layers, 1, cfg_o.n_heads, cfg_o.n_kv_heads,
                                  cfg_o.head_dim, MAX_LEN, [pos_step]),
            "olmo2_step_bf16": k8_case(cfg_o.n_layers, 1, cfg_o.n_heads, cfg_o.n_kv_heads,
                                       cfg_o.head_dim, MAX_LEN, [pos_step], cdtype=bf16),
            "tinyllama_engine_step": k8_case(L, 4, hq, hkv, d, MAX_LEN + 128,
                                             [255, 0, 300, MAX_LEN])},
        "attn_decode_qkv": {
            "tinyllama_step": k2_case(L, 1, hq, hkv, d, MAX_LEN, [pos_step], cfg.rope,
                                      cfg.norm_eps),
            "tinyllama_engine_step": k2_case(L, 4, hq, hkv, d, MAX_LEN + 128,
                                             [255, 0, 300, MAX_LEN + 128], cfg.rope, cfg.norm_eps),
            "qwen3_qk_norm_step": k2_case(cfg_q3.n_layers, 1, cfg_q3.n_heads, cfg_q3.n_kv_heads,
                                          cfg_q3.head_dim, MAX_LEN, [pos_step], cfg_q3.rope,
                                          cfg_q3.norm_eps, norms=True)},
        "flash_attention": {"tinyllama_chunk": k6_case(L, CHUNK, hq, hkv, d, MAX_LEN, [CHUNK])},
        "paged_attn_decode_update": {
            "serve_decode_step": k9_case(L, hq, hkv, d),
            "qwen25_g6_d128_bf16": k9_case(*q25, cdtype=bf16),
            "qwen25_g6_d128_f16": k9_case(*q25)},
        "paged_attention": {
            "serve_mixed_step": k10_case(L, hq, hkv, d),
            "qwen25_g6_d128_bf16": k10_case(*q25, cdtype=bf16),
            "qwen25_g6_d128_f16": k10_case(*q25)}}
    after16 = f16_counts({n: getattr(att, n) for n in before16})
    tol = 1e-6
    bad = [f"{name} {case} {qn}" for name, cases in forms.items() for case, r in cases.items()
           for qn, x in (("f32_q", r), ("bf16_q", r["bf16_q"])) if not x["nmse"] <= tol]
    bad += [f"{name} {case}: cache or pools differ" for name, cases in forms.items()
            for case, r in cases.items()
            for x in (r, r["bf16_q"]) if not x.get("v_cache_equal", True)
            or not x.get("pools_equal", True) or not x.get("k_cache_nmse", 0.0) <= 1e-9
            or not x.get("caches_equal", True)]
    line = {"phase": "kernel_f16", "card": card, "tolerance": tol,
            "step_graph_ms": step_ms, "f16_form_launches": {
                n: after16[n] - before16[n] for n in after16}, **forms,
            "note": "device ms a step's layers from CUDA-graph replay; bound: the bf16 rows' bytes "
                    "(two bytes an f16 K/V element) and operations over the bf16 tensor-core "
                    "peak; library: scaled_dot_product_attention on the same f16 K/V, q cast to "
                    "f16; the G 6, d 128 rows (Qwen2.5-1.5B's heads) in bf16 and f16; K8's "
                    "olmo2_step_bf16 the same step over a bf16 cache, in this call"}
    emit(line)
    if bad:
        fail(f"f16 forms disagree with their plain versions: {bad}")
    return line


def olmo2_f16_parity(torch, card: str):
    """K8's f16 form against its plain version at an OLMo-2-0425-1B decode
    step's heads (16 / 16 of 128, S 2048) over an f16 cache: rows at 331 and
    1999 and a trash row at S (it writes slot S - 1 and attends all S), f32
    and bf16 q, and q scaled so that the scores span more than 17 nats (f16
    subnormal probabilities); output within nmse 1e-6 (1e-5 for a bf16 q,
    whose output rounds to bf16), the caches after the insert equal, every
    launch counted in `.f16_launches`.  The OLMo-2 engine over a contiguous
    f16 cache is held against the CPU by small_engine_check's
    `olmo2_contiguous_f16` layout."""
    from zllm_torch.ops import attention as att

    g = torch.Generator(device="cuda")
    g.manual_seed(21)

    def randn(*shape_, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape_, generator=g, device="cuda") * scale).to(dtype)

    b, hq, hkv, d, s = 3, 16, 16, 128, MAX_LEN
    pos = torch.tensor([[331], [1999], [s]], dtype=torch.int32, device="cuda")
    got = {}
    before = att.attn_decode_update.launches, att.attn_decode_update.f16_launches
    for case, amp in (("normal", 1.0), ("wide", 6.0)):
        for qn, qd in (("f32_q", torch.float32), ("bf16_q", torch.bfloat16)):
            q = randn(b, 1, hq, d, dtype=qd, scale=amp)
            kn, vn = randn(b, 1, hkv, d, dtype=qd), randn(b, 1, hkv, d, dtype=qd)
            ka, va = randn(b, hkv, s, d, dtype=torch.float16), randn(b, hkv, s, d,
                                                                     dtype=torch.float16)
            kb, vb = ka.clone(), va.clone()
            o = att.attn_decode_update(q, kn, vn, ka, va, pos, scale=d ** -0.5)
            w = att.attn_decode_update_plain(q, kn, vn, kb, vb, pos, scale=d ** -0.5)
            torch.cuda.synchronize()
            p_ = torch.softmax(torch.einsum("hd,hsd->hs", q[0, 0].float(), kb[0, :, :332].float())
                               * d ** -0.5, dim=-1).to(torch.float16).float()
            got[f"{case} {qn}"] = dict(
                nmse=nmse(o.float(), w.float()),
                max_abs_err=float((o.float() - w.float()).abs().max()),
                tolerance=1e-6 if qd == torch.float32 else 1e-5,
                caches_equal=bool(torch.equal(ka, kb) and torch.equal(va, vb)),
                subnormal_probabilities=int(((p_ > 0) & (p_ < 2.0 ** -14)).sum()))
    launched = (att.attn_decode_update.launches - before[0],
                att.attn_decode_update.f16_launches - before[1])
    emit({"phase": "olmo2_contiguous_f16", "card": card, "k8_f16_vs_plain": got,
          "k8_launches": launched[0], "k8_f16_launches": launched[1],
          "shapes": f"q [{b},1,{hq},{d}], cache [{b},{hkv},{s},{d}] f16, pos "
                    f"{pos[:, 0].tolist()}"})
    bad = {k: r for k, r in got.items() if not (r["nmse"] <= r["tolerance"] and r["caches_equal"])}
    if bad or launched != (4, 4) or not got["wide f32_q"]["subnormal_probabilities"]:
        fail(f"K8's f16 form disagrees with its plain version: {bad}, launches {launched}")


ATTENTION_DIGEST_PARTS = ("attn_decode_qkv", "flash_attention", "attn_decode_update", "paged")


def _attention_parts(torch, randn, h, cname: str, cd, parts=ATTENTION_DIGEST_PARTS) -> dict:
    """Digests of K2, K6, K8 and K9/K10 ("paged") over caches or pools of
    dtype `cd`, in that order, each on inputs drawn from `randn` (see
    attention_digests)."""
    from zllm_torch.ops import attention as att
    from zllm_torch.ops.layers import RopeParams, rope_table

    f32, bf16 = torch.float32, torch.bfloat16
    s2 = MAX_LEN + 128
    out = {}
    if "attn_decode_qkv" in parts:
        res = []
        for b, hq, hkv, d, pos_vals, norms in ((4, 32, 4, 64, [1500, 0, s2, 255], False),
                                                 (1, 16, 8, 128, [331], True)):
            pos = torch.tensor(pos_vals, dtype=torch.int32, device="cuda")
            rope = rope_table(pos, RopeParams(dim=d, style="neox"), d)
            qkv3 = randn(b, hq + 2 * hkv, d)
            qw, kw = (randn(d), randn(d)) if norms else (None, None)
            for qd in (f32, bf16):
                kc, vc = randn(b, hkv, s2, d, dtype=cd), randn(b, hkv, s2, d, dtype=cd)
                o = att.attn_decode_qkv(qkv3.to(qd), kc, vc, pos, rope, qw, kw, scale=d ** -0.5)
                res.append(h(o, kc, vc))
        out[f"attn_decode_qkv {cname}"] = hashlib.sha256("".join(res).encode()).hexdigest()[:16]
    if "flash_attention" in parts:
        res = []
        for b, t, hq, hkv, d, starts in ((4, 128, 32, 4, 64, [0, 256, 300, MAX_LEN]),
                                         (1, CHUNK, 16, 16, 128, [CHUNK])):
            pos = (torch.tensor(starts, dtype=torch.int32, device="cuda")[:, None]
                   + torch.arange(t, dtype=torch.int32, device="cuda")[None])
            k, v = randn(b, hkv, s2, d, dtype=cd), randn(b, hkv, s2, d, dtype=cd)
            for qd in (f32, bf16):
                res.append(h(att.flash_attention(randn(b, t, hq, d, dtype=qd), k, v, pos,
                                                 scale=d ** -0.5)))
        out[f"flash_attention {cname}"] = hashlib.sha256("".join(res).encode()).hexdigest()[:16]
    if "attn_decode_update" in parts:
        res = []
        for b, hq, hkv, d, pos_vals in ((4, 32, 4, 64, [255, 0, 300, s2]),
                                        (1, 16, 16, 128, [331])):
            pos = torch.tensor(pos_vals, dtype=torch.int32, device="cuda")[:, None]
            for qd in (f32, bf16):
                q, kn, vn = (randn(b, 1, n_, d, dtype=qd) for n_ in (hq, hkv, hkv))
                kc, vc = randn(b, hkv, s2, d, dtype=cd), randn(b, hkv, s2, d, dtype=cd)
                o = att.attn_decode_update(q, kn, vn, kc, vc, pos, scale=d ** -0.5)
                res.append(h(o, kc, vc))
        out[f"attn_decode_update {cname}"] = hashlib.sha256("".join(res).encode()).hexdigest()[:16]
    if "paged" in parts:
        n_slots, ps, lp = 4, 128, MAX_LEN // 128
        table = _paged_table(torch, n_slots, lp, 2)
        r9, r10 = [], []
        for hq, hkv, d in ((32, 4, 64), (12, 2, 128)):
            kp = randn(hkv, (n_slots * lp + 1) * ps, d, dtype=cd)
            vp = randn(hkv, (n_slots * lp + 1) * ps, d, dtype=cd)
            pos9 = torch.tensor([[255], [0], [300], [lp * ps]], dtype=torch.int32, device="cuda")
            pos10 = (torch.tensor([0, 256, 300, lp * ps], dtype=torch.int32,
                                  device="cuda")[:, None]
                     + torch.arange(128, dtype=torch.int32, device="cuda")[None])
            for qd in (f32, bf16):
                r10.append(h(att.paged_attention(randn(n_slots, 128, hq, d, dtype=qd), kp, vp,
                                                 table, pos10, page_size=ps, scale=d ** -0.5)))
                q, kn, vn = (randn(n_slots, 1, n_, d, dtype=qd) for n_ in (hq, hkv, hkv))
                o = att.paged_attn_decode_update(q, kn, vn, kp, vp, table, pos9, page_size=ps,
                                                 scale=d ** -0.5)
                r9.append(h(o, kp, vp))
        out[f"paged_attn_decode_update {cname}"] = hashlib.sha256(
            "".join(r9).encode()).hexdigest()[:16]
        out[f"paged_attention {cname}"] = hashlib.sha256("".join(r10).encode()).hexdigest()[:16]
    return out


def _digest_tools(torch, seed: int):
    """A seeded normal draw on the card and a digest of tensors' f32 bytes."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape_, dtype=torch.float32):
        return torch.randn(*shape_, generator=g, device="cuda").to(dtype)

    def h(*xs) -> str:
        d = hashlib.sha256()
        for x in xs:
            d.update(x.float().cpu().numpy().tobytes())
        return d.hexdigest()[:16]

    return randn, h


def attention_digests(torch) -> dict:
    """Digests of the outputs (and the caches or pools after an insert) of
    the attention kernels' bf16 and f32 forms, and K7's bf16 and int8 ones,
    on seeded inputs at their main paths' shapes: K2 at an engine step (B 4,
    S 2176: a multi-chunk row, position 0, a trash row) with f32 and bf16
    q, and at Qwen3's q/k-norm form (d 128); K6 at a mixed step (T 128,
    rows from 0, 256, 300, 2048) and at an OLMo-2 chunk (d 128); K8 at an
    engine step and at OLMo-2's (d 128); K9 at a serve decode step and K10
    at a serve mixed step (4 slots, 16 pages of 128, a scrambled table), at
    d 64 and at G 6, d 128; K7 at the q8 decode and mixed steps, int8
    codes with f32 scales and bf16 K/V.  Each form's caches are f32 and
    bf16 (K7: int8 and bf16).  Equal digests on two trees mean bit-equal
    outputs."""
    from zllm_torch.ops import attention as att

    randn, h = _digest_tools(torch, 1)
    f32, bf16 = torch.float32, torch.bfloat16
    s2 = MAX_LEN + 128
    out = {}
    for cname, cd in (("f32", f32), ("bf16", bf16)):
        out.update(_attention_parts(torch, randn, h, cname, cd))
    # K7: int8 codes with f32 scales, and bf16 K/V; the q8 decode and mixed steps
    for kname in ("int8", "bf16"):
        res = []
        for t, starts in ((1, [255, 0, 300, MAX_LEN]), (128, [0, 256, 300, MAX_LEN])):
            pos = (torch.tensor(starts, dtype=torch.int32, device="cuda")[:, None]
                   + torch.arange(t, dtype=torch.int32, device="cuda")[None])
            if kname == "int8":
                k = (randn(4, 4, s2, 64) * 40).clamp(-127, 127).to(torch.int8)
                v = (randn(4, 4, s2, 64) * 40).clamp(-127, 127).to(torch.int8)
                ks, vs = randn(4, 4, s2, 1).abs() * 0.01, randn(4, 4, s2, 1).abs() * 0.01
            else:
                k, v, ks, vs = randn(4, 4, s2, 64, dtype=bf16), randn(4, 4, s2, 64, dtype=bf16), \
                    None, None
            for qd in (f32, bf16):
                res.append(h(att.flash_attention_blockwise(randn(4, t, 32, 64, dtype=qd), k, v,
                                                           pos, scale=0.125, ks=ks, vs=vs)))
        out[f"flash_attention_blockwise {kname}"] = hashlib.sha256(
            "".join(res).encode()).hexdigest()[:16]
    return out


def f16_attention_digests(torch) -> dict:
    """The same digests of the attention kernels' f16 forms (f16 caches and
    pools: K2, K6, K9 and K10 since the f16 KV slice, K8 since the next),
    each kernel on a stream of its own, so that a tree without one form
    ("absent": the wrapper raises NotImplementedError) keeps the others'
    digests."""
    out = {}
    for i, part in enumerate(ATTENTION_DIGEST_PARTS):
        randn, h = _digest_tools(torch, 100 + i)
        try:
            out.update(_attention_parts(torch, randn, h, "f16", torch.float16, (part,)))
        except NotImplementedError as err:
            out[f"{part} f16"] = f"absent ({err})"[:80]
    return out


DIGEST_BLOCKS = {"Q4_K": (256, 144, (0, 2)), "Q4_0": (32, 18, (0,)), "Q4_1": (32, 20, (0, 2)),
                 "Q5_0": (32, 22, (0,)), "Q5_1": (32, 24, (0, 2)), "Q5_K": (256, 176, (0, 2)),
                 "Q6_K": (256, 210, (208,)), "Q8_0": (32, 34, (0,)),
                 "Q2_K": (256, 84, (80, 82)), "Q3_K": (256, 110, (108,)),
                 "IQ4_NL": (32, 18, (0,)), "IQ4_XS": (256, 136, (0,)), "MXFP4": (32, 17, ())}


def form_digests(torch) -> dict:
    """Digests of the outputs of the kernel forms that predate the IQ grid
    slice: K1 and K3 in the Q4_K, Q4_0, Q4_1, Q5_0, Q5_1 and Q5_K forms, K4
    and K5 in the Q6_K, Q8_0, Q2_K, Q3_K, IQ4_NL, IQ4_XS and MXFP4 forms
    (and, under "attention", the attention kernels' forms that predate the
    f16 KV slice: `attention_digests`, its own random stream)
    (the low-bit ones after the others, so that those keep the digests
    they had before the low-bit ones were added), on weights of random GGUF bytes
    (every code and scale bit; fp16 scales in [0.002, 0.02)) at a TinyLlama
    layer's shapes (wqkv norm 2048->2560, wo q 2048->2048, gate|up norm
    2048->11264, down glu 5632->2048), the matvec on an f32 and a bf16 row,
    the GEMM at M = 4 and 256, all from seed 0 (the Q4 forms' first, with
    the random stream of the earlier `q4_digests`); then the attention
    kernels' f16 forms (`f16_attention_digests`) and K4's and K5's IQ grid
    and TQ forms (`later_form_digests`), each on a stream of its own.
    Equal digests on two trees mean bit-equal outputs."""
    import numpy as np

    from zllm_torch.gguf.constants import GGMLType
    from zllm_torch.ops import qmatmul as qmm

    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def randn(*shape_, scale=1.0):
        return torch.randn(*shape_, generator=g, device="cuda") * scale

    rng = np.random.default_rng(0)
    inputs = _digest_inputs(randn)
    out = {}
    for fmt, (per, size, scales) in DIGEST_BLOCKS.items():
        nibble = GGMLType[fmt] in qmm.NIBBLE_FMT_CODE
        mv, gm = (qmm.q4k_matvec, qmm.q4k_gemm) if nibble else (qmm.int8_matvec,
                                                                qmm.dequant_gemm)

        def gguf_rows(k, n):
            raw = rng.integers(0, 256, size=(n * k // per, size), dtype=np.uint8)
            for off in scales:
                vals = rng.uniform(0.002, 0.02, size=raw.shape[0]).astype(np.float16)
                raw[:, off:off + 2] = vals.view(np.uint8).reshape(-1, 2)
            if fmt == "MXFP4":
                raw[:, 0] = rng.integers(115, 135, size=raw.shape[0])
            return raw

        out[fmt] = _weight_digests(torch, GGMLType[fmt], gguf_rows, mv, gm, *inputs)
    out["attention"] = attention_digests(torch)
    out["attention_f16"] = f16_attention_digests(torch)
    out.update(later_form_digests(torch))
    out["layernorm"] = layernorm_form_digests(torch)
    out["gpt_oss"] = gpt_oss_form_digests(torch)
    return out


# a TinyLlama layer's matmuls (K, N, the matvec's prologue)
DIGEST_SHAPES = ((2048, 2560, "norm"), (2048, 2048, "q"), (2048, 11264, "norm"),
                 (5632, 2048, "glu"))


def _digest_inputs(randn):
    """The digests' RMS-norm weight, matvec rows by prologue and GEMM rows
    by K, drawn from `randn` in this order."""
    aux = randn(2048, scale=0.1) + 1.0
    rows = {"norm": randn(1, 2048, scale=3.0), "q": randn(1, 2048), "glu": randn(1, 2 * 5632)}
    return aux, rows, {2048: randn(256, 2048), 5632: randn(256, 5632)}


def _weight_digests(torch, gtype, gguf_rows, mv, gm, aux, rows, xm) -> dict:
    """Digests of the matvec `mv` (None: the format has none) on an f32 and
    a bf16 row and of the GEMM `gm` at M = 4 and 256, on weights of the
    GGUF rows `gguf_rows(k, n)` gives at each of DIGEST_SHAPES."""
    from zllm_torch.quant.repack import repack

    h1, h3 = hashlib.sha256(), hashlib.sha256()
    for k, n, fuse in DIGEST_SHAPES:
        w = repack(gguf_rows(k, n).reshape(n, -1), (n, k), gtype, "cuda")
        if mv is not None:
            for xdtype in (torch.float32, torch.bfloat16):
                y = mv(rows[fuse].to(xdtype), w, fuse, aux if fuse == "norm" else None, 1e-5)
                h1.update(y.cpu().numpy().tobytes())
        for m in (4, 256):
            h3.update(gm(xm[k][:m], w).cpu().numpy().tobytes())
    out = {gm.__name__: h3.hexdigest()[:16]}
    if mv is not None:
        out[mv.__name__] = h1.hexdigest()[:16]
    return out


# the matmul forms added since the digests above: K4's and K5's IQ grid
# forms (IQ1_M on K5 alone) and their ternary ones; TQ GGUF blocks and the
# offset of their fp16 d
LATER_DIGEST_FMTS = ("IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S", "IQ1_M",
                     "TQ1_0", "TQ2_0")
TQ_DIGEST_BLOCKS = {"TQ1_0": (54, 52), "TQ2_0": (66, 64)}


def later_form_digests(torch) -> dict:
    """Digests of K4's and K5's IQ grid and TQ forms, as form_digests takes
    the others' (the same layer shapes, rows and M), each format on a
    stream of its own (so that a tree lacking one form, "absent", keeps the
    others' digests): IQ weights of random code bytes at an RMS of 0.02
    (`random_iq_blocks`), TQ ones of random code bytes with d in [0.002,
    0.02); IQ1_M's matvec is K5's, so it has the GEMM digest alone."""
    import numpy as np

    from zllm_torch.gguf.constants import GGMLType
    from zllm_torch.ops import qmatmul as qmm
    from zllm_torch.testing import random_iq_blocks

    out = {}
    for i, fmt in enumerate(LATER_DIGEST_FMTS):
        gtype = GGMLType[fmt]
        g = torch.Generator(device="cuda")
        g.manual_seed(200 + i)

        def randn(*shape_, scale=1.0):
            return torch.randn(*shape_, generator=g, device="cuda") * scale

        rng = np.random.default_rng(200 + i)

        def gguf_rows(k, n):
            if fmt not in TQ_DIGEST_BLOCKS:
                return random_iq_blocks(gtype, n * k // 256, rng)
            size, off = TQ_DIGEST_BLOCKS[fmt]
            raw = rng.integers(0, 256, size=(n * k // 256, size), dtype=np.uint8)
            vals = rng.uniform(0.002, 0.02, size=raw.shape[0]).astype(np.float16)
            raw[:, off:off + 2] = vals.view(np.uint8).reshape(-1, 2)
            return raw

        mv = qmm.int8_matvec if gtype in qmm.K4_FMTS else None
        try:
            out[fmt] = _weight_digests(torch, gtype, gguf_rows, mv, qmm.dequant_gemm,
                                       *_digest_inputs(randn))
        except NotImplementedError as err:
            out[fmt] = f"absent ({err})"[:80]
    return out


# group 8: speculative decoding, lookahead and the whole-cache context
# shift on the TinyLlama Q4_K_M model (`python3 chip_smoke.py --spec` runs it
# alone): a 4-slot contiguous bf16 engine, chunk 128, max_len 1024 (S 1152)
SPEC_ENGINE = dict(n_slots=4, prefill_chunk=128, max_len=1024, kv_layout="contiguous")
SPEC_NEW_TOKENS = 48
SPEC_N_DRAFT = 6  # zllm's default: a verify step of 7 columns
SPEC_OFFSETS = (0, 23, 41, 67)  # the greedy prompts: the sentence from these characters
SPEC_DRAFT_LAYERS = 2  # the small draft: TinyLlama's width and vocab, 2 layers, Q4_K


def spec_requests(tok) -> list[dict]:
    """Four greedy requests with repetitive prompts (a sentence repeated,
    each from another character, so no two share a prefix) and one sampled
    request riding along."""
    line = ("The quick brown fox jumps over the lazy dog while the chip counts every "
            "byte it reads. ")
    greedy = [tok.encode((line * 4)[o:o + 240], add_special=True)[:150] for o in SPEC_OFFSETS]
    sampled = tok.encode(letters(21, 90), add_special=True)
    return ([dict(prompt_tokens=p, max_new=SPEC_NEW_TOKENS, temp=0.0) for p in greedy]
            + [dict(prompt_tokens=sampled, max_new=SPEC_NEW_TOKENS, temp=0.8, seed=5)])


def gemm_counts(model) -> dict:
    """K3 and K5 launches of one multi-row forward of `model`: each
    quantized matmul weight and the head, by format (an MoE layer's router
    and shared expert where quantized; its experts are counted from the
    recorded routing, `expert_launches`)."""
    from zllm_torch.ops import qmatmul as qmm
    from zllm_torch.quant.repack import QWeight

    ws = [w for layer in model.params["layers"] for k, w in layer.items()
          if k in ("wqkv", "wq", "wk", "wv", "wo", "ffn_gateup", "ffn_gate", "ffn_up",
                   "ffn_down", "ffn_gate_inp",
                   "ffn_gateup_shexp", "ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp",
                   "ffn_gate_inp_shexp")]
    ws.append(model.params["output"])
    # a weight zllm's kernels do not take (K % 256, N % 128) is dequantized
    # and multiplied by torch.matmul (`ops/linear.py`), no kernel
    ws = [w for w in ws if isinstance(w, QWeight) and qmm.supports(w)]
    k3 = sum(w.fmt in qmm.NIBBLE_FMT_CODE for w in ws)
    return {"q4k_gemm": k3, "dequant_gemm": len(ws) - k3}


def spec_expected(kernels: dict, model, steps: dict, calls: dict, draft=None) -> dict:
    """The launches of a spec/lookahead engine window from its step
    counters and its instrumented step kinds (`calls`): every step the
    model's GEMMs; K2 a layer for each plain decode step and 1 + n_draft a
    layer for each verify step (once a column); K6 + K2 (column 0) a layer
    for each mixed step and each lookahead flush; none for a lookahead
    step (its masked attention is plain PyTorch); the draft model's GEMMs
    and attention for each of its catch-up (T = chunk) and chain (T = 1)
    forwards."""
    L = model.cfg.n_layers
    dec, pre = steps["decode_steps_total"], steps["prefill_steps_total"]
    verify, la, flush = calls["verify"], calls["lookahead"], calls["flush"]
    t = SPEC_N_DRAFT + 1
    expected = {name: 0 for name in kernels}
    for name, n in gemm_counts(model).items():
        expected[name] += n * (dec + pre + flush)
    expected["attn_decode_qkv"] = L * (dec - verify - la + pre + flush + t * verify)
    expected["flash_attention"] = L * (pre + flush)
    if draft is not None:
        wide, one = calls["draft_wide"], calls["draft_one"]
        for name, n in gemm_counts(draft).items():
            expected[name] += n * (wide + one)
        expected["attn_decode_qkv"] += draft.cfg.n_layers * (wide + one)
        expected["flash_attention"] += draft.cfg.n_layers * wide
    return expected


def _la_columns(eng, mask, toks, arg, s: int, n_emitted: int) -> list[int]:
    """The columns of a lookahead step whose argmax gave a greedy slot's
    emitted tokens, found as `_lookahead_step` finds them: the last
    pending column (a pending column attends its prefix, a pad only its
    own slot), then the longest verified gram's columns."""
    n, w, g = eng.la_n, eng.la_w, eng.la_g
    lvls = n - 1
    m = sum(int(mask[s, j].sum()) > 1 for j in range(n))
    col_v0 = n + lvls * w
    best: list[int] = []
    cur0 = int(arg[s, m - 1])
    for gi in range(g):
        cur, cols = cur0, []
        for tt in range(lvls):
            c = col_v0 + gi * lvls + tt
            if int(toks[s, c]) != cur:
                break
            cur = int(arg[s, c])
            cols.append(c)
        if len(cols) > len(best):
            best = cols
    return ([m - 1] + best)[:n_emitted]


def spec_engine_run(torch, model, kernels: dict, reqs: list[dict], label: str,
                    record: str = "", **kw) -> dict:
    """A SPEC_ENGINE engine (`kw`: speculative, draft_model, lookahead)
    serving `reqs`, submitted together after a warm-up, the launch counts
    set to 0 just before and read just after; its verify steps, lookahead
    steps, flushes and draft forwards counted by wrapping the engine's
    methods.  `record` = "plain": each greedy token's logits row (its
    sampled row); "lookahead": the row of the masked column that gave it;
    "drafts": each draft proposal with the request's token count."""
    from zllm_torch.server.engine import Engine, Request

    eng = Engine(model, **SPEC_ENGINE, **kw)
    calls = {k: 0 for k in ("verify", "lookahead", "flush", "draft_wide", "draft_one")}
    rows: dict[str, dict[int, object]] = {}
    proposals: list[tuple] = []
    captured = {}

    def wrap(name, before=None, after=None):
        real = getattr(eng, name)

        def fn(*a, **k):
            ctx = before(*a, **k) if before else None
            out = real(*a, **k)
            if after:
                after(ctx, out, *a, **k)
            return out

        setattr(eng, name, fn)

    def count(key):
        def before(*a, **k):
            calls[key] += 1
        return before

    step_errors: list[str] = []
    real_step = eng._step_once

    def step_once():  # the engine turns a step's exception into request errors: keep its trace
        try:
            real_step()
        except Exception:
            import traceback

            step_errors.append(traceback.format_exc()[-3000:])
            raise

    eng._step_once = step_once
    wrap("_spec_decode_step", count("verify"))
    wrap("_flush_la_extras", count("flush"))
    wrap("_draft_argmax", lambda toks, pos: calls.__setitem__(
        "draft_wide" if toks.shape[1] > 1 else "draft_one",
        calls["draft_wide" if toks.shape[1] > 1 else "draft_one"] + 1))
    if record == "plain":
        def keep_rows(logits, cols, slots):  # before the rows are sampled and emitted
            for s in slots:
                if s.req.temp <= 0:
                    rows.setdefault(s.req.rid, {})[len(s.req.out_tokens)] = (
                        logits[s.idx, int(cols[s.idx])].float().cpu())

        wrap("_sample_and_emit", keep_rows)
    elif record == "drafts":
        wrap("_draft_propose_all", after=lambda ctx, out, slots: proposals.extend(
            (s.req.rid, len(s.req.out_tokens), list(out[s.idx])) for s in slots))

    def la_before(gen_slots):
        calls["lookahead"] += 1
        return {s.idx: (s.req, len(s.req.out_tokens)) for s in gen_slots}

    def la_after(ctx, out, gen_slots):
        if record != "lookahead":
            return
        toks, mask, logits = captured.pop("step")
        arg = logits.argmax(-1).cpu()
        for idx, (req, n0) in ctx.items():
            if req.temp > 0:
                continue
            emitted = len(req.out_tokens) - n0
            for k, c in enumerate(_la_columns(eng, mask, toks, arg, idx, emitted)):
                rows.setdefault(req.rid, {})[n0 + k] = logits[idx, c].float().cpu()

    wrap("_lookahead_step", la_before, la_after)
    if record == "lookahead":
        def keep_step(ctx, out, toks, pos, logits_for, **k):
            if "mask" in k:
                captured["step"] = (toks, k["mask"], out)

        wrap("_forward", after=keep_step)

    eng.start()
    try:
        warm = eng.submit(Request(prompt_tokens=model.tokenizer.encode(letters(31, 40),
                                                                      add_special=True),
                                  max_new=8, temp=0.0))
        wait_done([warm])
        torch.cuda.synchronize()
        zero_counts(kernels, (kernels["flash_attention"],))
        for k in calls:
            calls[k] = 0
        rows.clear()
        proposals.clear()
        m0 = dict(eng.metrics)
        t0 = time.perf_counter()
        got = eng.run_in_loop(lambda: [eng.submit(Request(**r)) for r in reqs])
        wait_done(got, 600)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        m1 = dict(eng.metrics)
    finally:
        eng.stop()
    steps = {k: m1[k] - m0[k] for k in m1}
    if steps["engine_errors_total"] or step_errors:
        fail(f"{label}: {steps['engine_errors_total']} engine step errors: {step_errors}")
    expected = spec_expected(kernels, model, steps, calls, kw.get("draft_model"))
    counts = engine_counts_check(torch, label, kernels, expected, False,
                                 kernels["flash_attention"], expected["flash_attention"])
    gen_tokens = sum(len(q.out_tokens) for q in got)
    return {"requests": got, "steps": steps, "calls": calls, "counts": counts,
            "expected": expected, "window_s": window, "generated_tokens": gen_tokens,
            "tok_s": gen_tokens / window, "rows": rows, "proposals": proposals,
            "errors": [q.error for q in got if q.error]}


def _top2_gap(row) -> float:
    top = row.topk(2).values
    return float(top[0] - top[1])


def _spec_summary(run: dict, plain: dict, reqs: list[dict]) -> list[dict]:
    """A spec or lookahead run against the plain engine's: each greedy
    request's tokens equal or not, its first divergence."""
    out = []
    for q, p, r in zip(run["requests"], plain["requests"], reqs):
        same = list(q.out_tokens) == list(p.out_tokens)
        item = {"greedy": r["temp"] == 0, "tokens": len(q.out_tokens), "equal_plain": same}
        if not same and r["temp"] == 0:
            i = next((k for k, (a, b) in enumerate(zip(q.out_tokens, p.out_tokens)) if a != b),
                     min(len(q.out_tokens), len(p.out_tokens)))
            item["first_divergence"] = i
        out.append(item)
    return out


def spec_phases_run(torch, model, kernels: dict, card: str) -> dict:
    """Group 8's engine phases: plain, spec_ngram, spec_draft_self,
    spec_draft_small, lookahead.  Returns the spec_ngram counts."""
    from zllm_torch.models.loader import Model

    reqs = spec_requests(model.tokenizer)
    cfg = model.cfg
    t0 = time.perf_counter()
    plain = spec_engine_run(torch, model, kernels, reqs, "spec_plain", record="plain")
    emit({"phase": "spec_plain", "model": "tinyllama-geometry Q4_K_M (random weights, seed 0)",
          **{k: v for k, v in SPEC_ENGINE.items()}, "kv_dtype": "bfloat16",
          "engine_counters": plain["steps"], "window_s": plain["window_s"],
          "generated_tokens": plain["generated_tokens"], "tok_s": plain["tok_s"],
          "launches": plain["counts"], "seconds": time.perf_counter() - t0, "card": card})
    if plain["errors"]:
        fail(f"spec_plain: engine errors {plain['errors']}")
    greedy_idx = [i for i, r in enumerate(reqs) if r["temp"] == 0]
    plain_rows = {plain["requests"][i].rid: plain["rows"].get(plain["requests"][i].rid, {})
                  for i in greedy_idx}

    def row_of(i, k):
        return plain_rows[plain["requests"][i].rid].get(k)

    out = {}
    small_path, small_s = gguf_file("tinyllama_draft", dict(main_shapes()["tinyllama"][0],
                                                            n_layers=SPEC_DRAFT_LAYERS), "Q4_K")
    small = Model.load(str(small_path), device="cuda", dtype=torch.bfloat16)
    for phase, kw in (("spec_ngram", dict(speculative=True)),
                      ("spec_draft_self", dict(draft_model=model)),
                      ("spec_draft_small", dict(draft_model=small))):
        t0 = time.perf_counter()
        run = spec_engine_run(torch, model, kernels, reqs, phase, n_draft=SPEC_N_DRAFT,
                              record="drafts" if "draft" in phase else "", **kw)
        summary = _spec_summary(run, plain, reqs)
        drafted, accepted = run["steps"]["spec_drafted_total"], run["steps"]["spec_accepted_total"]
        rejected = []
        if phase == "spec_draft_self":  # where a self-draft is rejected: the plain top-2 gap
            final = {q.rid: (i, list(q.out_tokens)) for i, q in enumerate(run["requests"])}
            for rid, n0, d in run["proposals"]:
                i, toks = final[rid]
                a = 0
                while a < len(d) and n0 + a < len(toks) and d[a] == toks[n0 + a]:
                    a += 1
                if a < len(d) and n0 + a < len(toks):
                    row = row_of(i, n0 + a)
                    rejected.append({"request": i, "token_index": n0 + a,
                                     "position": len(reqs[i]["prompt_tokens"]) + n0 + a,
                                     "plain_top2_gap": None if row is None else _top2_gap(row)})
        res = {"phase": phase, "n_draft": SPEC_N_DRAFT, "drafted": drafted,
               "accepted": accepted, "accepted_over_drafted": accepted / max(drafted, 1),
               "requests": summary, "engine_counters": {k: run["steps"][k] for k in (
                   "decode_steps_total", "prefill_steps_total", "spec_drafted_total",
                   "spec_accepted_total", "tokens_generated_total")},
               "verify_steps": run["calls"]["verify"], "draft_forwards": {
                   "catch_up": run["calls"]["draft_wide"], "chain": run["calls"]["draft_one"]},
               "window_s": run["window_s"], "tok_s": run["tok_s"], "plain_tok_s": plain["tok_s"],
               "speedup_over_plain": run["tok_s"] / plain["tok_s"],
               "launches": run["counts"], "launches_expected": run["expected"],
               "seconds": time.perf_counter() - t0, "card": card}
        if phase == "spec_draft_small":
            res["draft"] = {"file": small_path.name, "layers": SPEC_DRAFT_LAYERS, "made_s": small_s}
        if phase == "spec_draft_self":
            res["rejected"] = rejected
        emit(res)
        if run["errors"]:
            fail(f"{phase}: engine errors {run['errors']}")
        bad = [i for i, s in enumerate(summary) if s["greedy"] and not s["equal_plain"]]
        if bad:
            fail(f"{phase}: greedy tokens differ from the plain engine's: {summary}")
        if not drafted or not run["calls"]["verify"]:
            fail(f"{phase}: nothing was drafted")
        out[phase] = run["counts"]
    del small

    t0 = time.perf_counter()
    run = spec_engine_run(torch, model, kernels, reqs, "lookahead", record="lookahead",
                          lookahead=True)
    summary = _spec_summary(run, plain, reqs)
    far = []
    for i, s in zip(range(len(reqs)), summary):
        if "first_divergence" not in s:
            continue
        k = s["first_divergence"]
        prow, lrow = row_of(i, k), run["rows"].get(run["requests"][i].rid, {}).get(k)
        if prow is None or lrow is None:
            s["diagnosis"] = "no logits row recorded"
            far.append(i)
            continue
        gap, diff = _top2_gap(prow), float((lrow - prow).abs().max())
        s.update(plain_top2_gap=gap, masked_column_max_abs_diff=diff,
                 near_tie=gap <= 4 * diff)
        if gap > 4 * diff:
            far.append(i)
    res = {"phase": "lookahead", "la_w": 4, "la_n": 3, "la_g": 4,
           "step_columns": 3 + (4 + 4) * 2, "requests": summary,
           "lookahead_steps": run["steps"]["lookahead_steps_total"],
           "lookahead_accepted_total": run["steps"]["lookahead_accepted_total"],
           "flushes": run["calls"]["flush"], "engine_counters": {k: run["steps"][k] for k in (
               "decode_steps_total", "prefill_steps_total", "tokens_generated_total")},
           "window_s": run["window_s"], "tok_s": run["tok_s"], "plain_tok_s": plain["tok_s"],
           "speedup_over_plain": run["tok_s"] / plain["tok_s"],
           "launches": run["counts"], "launches_expected": run["expected"],
           "seconds": time.perf_counter() - t0, "card": card}
    emit(res)
    if run["errors"]:
        fail(f"lookahead: engine errors {run['errors']}")
    if far:
        fail(f"lookahead: greedy tokens diverge from the plain engine's away from a near tie "
             f"(top-2 gap above 4x the masked column's difference): {summary}")
    if not run["steps"]["lookahead_steps_total"]:
        fail("lookahead: no lookahead step ran")
    out["lookahead"] = run["counts"]
    return out


def spec_kernels_phase(torch, model, kernels: dict, card: str) -> dict:
    """Group 8's kernel checks at the verify shapes: K3 and K5 at M = 28
    (4 slots x 7 columns) and 76 (4 x 19, a lookahead step) against their
    plain versions (nmse <= 1e-6) and their first 4 rows against an M = 4
    call's, bit for bit; K6 with 7 query rows a slot over S = 1152 (nmse <=
    1e-5); a verify step's column-j logits against the decode step's at
    that position, bit for bit; the verify step and the decode step
    captured in CUDA graphs, and the verify step's 7 K2 launches a layer
    against the decode step's one; `shift_context` on the card against the
    CPU's; SpeculativeDecoder and lookahead_generate at B = 1 against the
    Generator's tokens (printed, not required: the B = 1 decode step runs
    the matvec kernels, the verify step the GEMMs)."""
    from zllm_torch.lookahead import lookahead_generate
    from zllm_torch.models.llama import forward
    from zllm_torch.ops import attention as att
    from zllm_torch.ops import qmatmul as qmm
    from zllm_torch.ops.layers import RopeParams, rope_table
    from zllm_torch.runtime.generate import Generator
    from zllm_torch.runtime.kvcache import KVCache, shift_context
    from zllm_torch.runtime.speculative import SpeculativeDecoder

    import numpy as np

    t0 = time.perf_counter()
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(24)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)

    lay = model.params["layers"][0]
    gemms = {}
    for name, fn, plain_fn, w in (("q4k_gemm", qmm.q4k_gemm, qmm.q4k_gemm_plain,
                                   lay["ffn_gateup"]),
                                  ("dequant_gemm", qmm.dequant_gemm, qmm.dequant_gemm_plain,
                                   lay["ffn_down"])):
        k, n = w.shape
        for m in (28, 76):
            x = randn(m, k)
            y, yp = fn(x, w), plain_fn(x, w)
            bpw = GGUF_BYTES_PER_WEIGHT[w.fmt.name]
            b = bound_ms(k * n * bpw + 2 * m * (k + n), 2 * m * k * n, "bf16")
            wd = w.dequant(torch.bfloat16)
            gemms[f"{name}_m{m}"] = dict(
                fmt=w.fmt.name, k=k, n=n, nmse=nmse(y, yp), tolerance=1e-6,
                max_abs_err=float((y.float() - yp.float()).abs().max()),
                rows_m4_equal=bool(torch.equal(fn(x[:4].contiguous(), w), y[:4])),
                ms=cuda_ms(lambda x=x, fn=fn: fn(x, w), 20),
                plain_ms=cuda_ms(lambda x=x, plain_fn=plain_fn: plain_fn(x, w), 5),
                library_ms=cuda_ms(lambda x=x: torch.matmul(x, wd), 20),
                bound_ms=b[0], bound_by=b[1])
    # K6: 7 query rows a slot over the engine's stripe
    s_len, t = SPEC_ENGINE["max_len"] + SPEC_ENGINE["prefill_chunk"], SPEC_N_DRAFT + 1
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = randn(4, t, hq, d)
    kc, vc = randn(4, hkv, s_len, d), randn(4, hkv, s_len, d)
    pos = (torch.tensor([100, 400, 700, 1016], dtype=torch.int32, device="cuda")[:, None]
           + torch.arange(t, dtype=torch.int32, device="cuda")[None])
    scale = d ** -0.5
    o6 = att.flash_attention(q, kc, vc, pos, scale=scale)
    o6p = att.flash_attention_plain(q, kc, vc, pos, scale=scale)
    # q and out once, the K/V each row sees once; 4 Hq D operations a
    # (query, slot) pair
    b6 = bound_ms(2 * 2 * q.numel() + 2 * 2 * hkv * d * int((pos[:, -1] + 1).sum()),
                  4 * hq * d * int((pos + 1).sum()), "bf16")
    k6 = dict(shape=f"B 4, T {t}, S {s_len}, Hq {hq}, Hkv {hkv}, d {d}", nmse=nmse(o6, o6p),
              tolerance=1e-5, max_abs_err=float((o6.float() - o6p.float()).abs().max()),
              ms=cuda_ms(lambda: att.flash_attention(q, kc, vc, pos, scale=scale), 20),
              plain_ms=cuda_ms(lambda: att.flash_attention_plain(q, kc, vc, pos, scale=scale), 5),
              bound_ms=b6[0], bound_by=b6[1])

    # a verify step's columns against decode steps, the whole model
    kv = KVCache.create(cfg.n_layers, 4, s_len, hkv, d, torch.bfloat16, "cuda")
    r = np.random.default_rng(24)
    prompt = torch.from_numpy(r.integers(3, 200, size=(4, 128)).astype(np.int32)).cuda()
    with torch.inference_mode():
        forward(model.params, cfg, prompt,
                torch.arange(128, dtype=torch.int32, device="cuda")[None].repeat(4, 1), kv)
    toks = torch.from_numpy(r.integers(3, 200, size=(4, t)).astype(np.int32)).cuda()
    trash = SPEC_ENGINE["max_len"]
    vpos = 128 + torch.arange(t, dtype=torch.int32, device="cuda")[None].repeat(4, 1)
    vpos[3, 1:] = trash  # a row that decodes one token, no drafts

    def clone(c):
        return KVCache([x.clone() for x in c.k], [x.clone() for x in c.v])

    kv_v, kv_d = clone(kv), clone(kv)
    with torch.inference_mode():
        lv = forward(model.params, cfg, toks, vpos, kv_v, verify=True)
        same, total, worst = 0, 0, 0.0
        for j in range(t):
            ld = forward(model.params, cfg, toks[:, j:j + 1].contiguous(),
                         vpos[:, j:j + 1].contiguous(), kv_d, logits_for="last")
            for row in range(4 if j == 0 else 3):
                total += 1
                same += bool(torch.equal(lv[row, j], ld[row, 0]))
                worst = max(worst, float((lv[row, j] - ld[row, 0]).abs().max()))
        # the two steps' device time, captured in CUDA graphs
        dtok, dpos = toks[:, :1].contiguous(), vpos[:, :1].contiguous()

    def verify_step():
        with torch.inference_mode():
            forward(model.params, cfg, toks, vpos, kv_v, verify=True)

    def decode_step():
        with torch.inference_mode():
            forward(model.params, cfg, dtok, dpos, kv_d, logits_for="last")

    verify_ms, decode_ms = cuda_ms(verify_step, 10), cuda_ms(decode_step, 10)
    # K2 alone: one decode step's 22 launches against a verify step's 154
    qkv3 = randn(4, hq + 2 * hkv, d)
    ropes = [rope_table(vpos[:, j].contiguous(), cfg.rope, d) for j in range(t)]
    cols = [vpos[:, j].contiguous() for j in range(t)]

    def k2(j):
        return [att.attn_decode_qkv(qkv3, kv_v.k[il], kv_v.v[il], cols[j], ropes[j], scale=scale)
                for il in range(cfg.n_layers)]

    k2_decode_ms = cuda_ms(lambda: k2(0), 20)
    k2_verify_ms = cuda_ms(lambda: [k2(j) for j in range(t)], 10)
    verify = dict(columns=t, rows=4, logits_equal=f"{same}/{total}", max_abs_diff=worst,
                  verify_step_graph_ms=verify_ms, decode_step_graph_ms=decode_ms,
                  k2_decode_step_ms=k2_decode_ms, k2_verify_step_ms=k2_verify_ms,
                  k2_launches=dict(decode=cfg.n_layers, verify=cfg.n_layers * t))

    # shift_context on the card against the CPU's
    shifts = {}
    for dt in (torch.float32, torch.bfloat16):
        base = KVCache([randn(4, hkv, s_len, d, dtype=dt) for _ in range(2)],
                       [randn(4, hkv, s_len, d, dtype=dt) for _ in range(2)])
        cpu = KVCache([x.cpu() for x in base.k], [x.cpu() for x in base.v])
        rope = RopeParams(dim=d, base=10000.0, style="neox")
        shift_context(base, rope, 4, (s_len - 4) // 2)  # the engine's n_discard
        shift_context(cpu, rope, 4, (s_len - 4) // 2)
        shifts[str(dt)[6:]] = dict(
            k_nmse=max(nmse(a.cpu(), b) for a, b in zip(base.k, cpu.k)),
            k_max_abs_diff=max(float((a.cpu().float() - b.float()).abs().max())
                               for a, b in zip(base.k, cpu.k)),
            v_equal=all(torch.equal(a.cpu(), b) for a, b in zip(base.v, cpu.v)),
            tolerance=1e-12 if dt == torch.float32 else 1e-5)

    # the single-sequence decoders at B = 1 against the Generator
    ids = spec_requests(model.tokenizer)[0]["prompt_tokens"]
    t1 = time.perf_counter()
    want = Generator(model, max_len=1024, prefill_chunk=128).generate(ids, max_new=32).tokens
    t_gen = time.perf_counter() - t1
    t1 = time.perf_counter()
    sd = SpeculativeDecoder(model, None, n_draft=SPEC_N_DRAFT, max_len=1024)
    got_sd = sd.generate(ids, max_new=32)
    t_sd = time.perf_counter() - t1
    t1 = time.perf_counter()
    got_la, la_stats = lookahead_generate(model, ids, 32, w=4, n=3, g=4, max_len=1024)
    t_la = time.perf_counter() - t1

    def agree(a, b):
        return next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))

    single = dict(prompt_tokens=len(ids), new_tokens=32, generator_s=t_gen,
                  speculative_decoder=dict(equal=got_sd == want, agree_first=agree(got_sd, want),
                                           drafted=sd.n_drafted, accepted=sd.n_accepted,
                                           seconds=t_sd),
                  lookahead_generate=dict(equal=got_la == want, agree_first=agree(got_la, want),
                                          **la_stats, seconds=t_la),
                  note="B = 1: plain decode on K1/K4, the verify step on K3/K5 (zllm's split); "
                       "printed, not required")
    res = {"phase": "spec_kernels", **gemms, "flash_attention_7_rows": k6,
           "verify_columns": verify, "shift_context": shifts, "single_sequence": single,
           "seconds": time.perf_counter() - t0, "card": card}
    emit(res)
    bad = [k for k, v in gemms.items() if not v["nmse"] <= v["tolerance"] or not v["rows_m4_equal"]]
    if not k6["nmse"] <= 1e-5:
        bad.append("flash_attention_7_rows")
    if same != total:
        bad.append(f"verify columns {same}/{total} equal to the decode steps' logits")
    bad += [f"shift_context {k}" for k, v in shifts.items()
            if not (v["k_nmse"] <= v["tolerance"] and v["v_equal"])]
    if bad:
        fail(f"spec_kernels: {bad}")
    return res


def spec_group(torch, model, kernels: dict, card: str) -> dict:
    """Group 8 on the loaded TinyLlama Q4_K_M model; returns the engine
    phases' launch counts and the kernel phase's line."""
    t0 = time.perf_counter()
    counts = spec_phases_run(torch, model, kernels, card)
    kern = spec_kernels_phase(torch, model, kernels, card)
    emit({"phase": "spec_group", "seconds": time.perf_counter() - t0, "card": card})
    return {"counts": counts, "kernels": kern}


def spec_phases():
    """`python3 chip_smoke.py --spec`: group 8 alone after building the
    kernels, on the TinyLlama Q4_K_M model."""
    torch, card = setup_card()
    from zllm_torch.models.loader import Model
    from zllm_torch.ops import cuda

    t0 = time.perf_counter()
    reports = cuda.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "built": sorted(reports)})
    kernels = kernel_wrappers()
    path, made_s = gguf_file("tinyllama", main_shapes()["tinyllama"][0], "Q4_K_M")
    model = Model.load(str(path), device="cuda", dtype=torch.bfloat16)
    emit({"phase": "spec_model", "file": path.name, "made_s": made_s})
    spec_group(torch, model, kernels, card)
    print(card, flush=True)


# ---- group 9: the Gemma text families ---------------------------------------

def unfused_want(kernels: dict, model):
    """`want(cfg, n_steps, n_chunks)` of a generate whose decode step runs
    no fused matvec (Gemma's geglu FFN, the layer-norm families' blocks)
    over the plain stripe: each matmul weight once a decode step (K1 for
    the nibble formats, K4 for the others: gate|up or up one matvec) and
    once a chunk (K3, K5); a tied head is a dense matmul, no kernel; every
    layer, windowed or not, K2 a step and a chunk (column 0) and K6 a
    chunk."""
    g = gemm_counts(model)

    def want(cfg, n_steps, n_chunks):
        L = cfg.n_layers
        return dict({name: 0 for name in kernels}, q4k_matvec=g["q4k_gemm"] * n_steps,
                    int8_matvec=g["dequant_gemm"] * n_steps, q4k_gemm=g["q4k_gemm"] * n_chunks,
                    dequant_gemm=g["dequant_gemm"] * n_chunks,
                    attn_decode_qkv=L * (n_steps + n_chunks), flash_attention=L * n_chunks)

    return want


# the 2-layer checks: model name -> prompt ids (past the check's window)
GEMMA_CHECKS = {"gemma2_2layer": GEMMA2_CHECK_WINDOW + 88, "gemma3_2layer": 1024 + 88}
_CPU_CHECKS: dict[str, subprocess.Popen] = {}


def _two_layer_run(torch, name: str, dev: str, forced=None) -> dict:
    """One side of a 2-layer check on `dev` (group 9's Gemma files, group
    11's layer-norm ones): the prompt (GEMMA_CHECKS' length, or
    LN_CHECK_PROMPT) in 256-token chunks (the last token's logits), then
    GEMMA_CHECK_STEPS decode steps, each
    fed the argmax of the step before on this side (the CPU) or `forced`
    (the card: the CPU's tokens).  Returns the ids, the fed tokens and the
    logits."""
    from zllm_torch.models.llama import forward
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.kvcache import KVCache

    prompt_n = GEMMA_CHECKS.get(name, LN_CHECK_PROMPT)
    path, _ = gguf_file(name, main_shapes()[name][0], "Q4_K")
    m = Model.load(str(path), device=dev, dtype=torch.bfloat16)
    cfg = m.cfg
    ids = prompt_ids(m.tokenizer, prompt_n)
    kv = KVCache.create(cfg.n_layers, 1, prompt_n + CHUNK, cfg.n_kv_heads, cfg.head_dim,
                        torch.bfloat16, dev)

    def run(toks, start):
        tt = torch.tensor([toks], dtype=torch.int32, device=dev)
        pp = torch.arange(start, start + len(toks), dtype=torch.int32, device=dev)[None]
        with torch.inference_mode():
            return forward(m.params, cfg, tt, pp, kv, logits_for="last")[0, -1].float().cpu()

    for start in range(0, prompt_n, CHUNK):
        last = run(ids[start:start + CHUNK], start)
    logits, fed = [last], []
    for i in range(GEMMA_CHECK_STEPS):
        fed.append(int(torch.argmax(logits[-1])) if forced is None else forced[i])
        logits.append(run([fed[-1]], prompt_n + i))
    if dev == "cuda":
        torch.cuda.synchronize()
    return {"ids": ids, "fed": fed, "logits": torch.stack(logits)}


def start_gemma_children():
    """After the build: the Gemma files' children and the 2-layer checks'
    CPU side, all niced, so that they take the cores the card's phases
    leave (group 9 comes last)."""
    prepare_requantized([(name, ("Q4_K_M",)) for name in GEMMA_MODELS])
    start_gemma_cpu_checks()


def gemma_cpu_reference(name: str):
    """`chip_smoke.py --gemma-cpu NAME` (a child, started after the build
    so that it overlaps the card's earlier phases; `--ln-cpu NAME` the same
    at nice 19 on two threads): the CPU's plain side of a 2-layer check,
    saved for `gemma_2layer_check` or `ln_2layer_check`."""
    import torch

    out = CACHE / f"{name}_cpu_reference.pt"
    ref = _two_layer_run(torch, name, "cpu")
    _write_atomic(out, lambda p: torch.save(ref, str(p)))


def start_gemma_cpu_checks():
    """Start one child a 2-layer check (`--gemma-cpu NAME`; it nices itself)."""
    import atexit

    for name in GEMMA_CHECKS:
        _CPU_CHECKS[name] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--gemma-cpu", name], cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: [c.kill() for c in _CPU_CHECKS.values() if c.poll() is None])


def two_layer_check(torch, kernels: dict, card: str, name: str, *, phase: str, info: dict,
                    must: tuple, tie_gap: float | None = None) -> dict:
    """2 layers at a model's full width, Q4_K (the factory's), bf16 weights
    and KV: the card against the CPU's plain forward (its child's saved
    logits), the CPU's greedy tokens fed to both (`_two_layer_run`);
    logits within nmse 1e-3 at every step, the kernels `must` launched.
    Each step whose card argmax is not the CPU's is listed with the CPU's
    score gap between the two picks and the step's rms |card - CPU| logit
    difference: with `tie_gap` (group 11) it passes only where that gap is
    below `tie_gap` (a tiled head's exact row copies score 0 apart),
    without (group 9) the agreement is reported."""
    t0 = time.perf_counter()
    child = _CPU_CHECKS.pop(name)
    err = child.communicate(timeout=1200)[1]
    if child.returncode != 0:
        fail(f"{name}: the CPU reference failed: {err[-2000:]}")
    cpu = torch.load(str(CACHE / f"{name}_cpu_reference.pt"))
    waited = time.perf_counter() - t0
    before = {n: fn.launches for n, fn in kernels.items()}
    gpu = _two_layer_run(torch, name, "cuda", forced=cpu["fed"])
    launched = {n: fn.launches - before[n] for n, fn in kernels.items()}
    if gpu["ids"] != cpu["ids"]:
        fail(f"{name}: the card's prompt ids differ from the CPU's")
    errs = [nmse(a, b) for a, b in zip(gpu["logits"], cpu["logits"])]
    rms = [float((a - b).pow(2).mean().sqrt()) for a, b in zip(gpu["logits"], cpu["logits"])]
    apart = []
    for i, (a, b) in enumerate(zip(gpu["logits"], cpu["logits"])):
        g, c = int(torch.argmax(a)), int(torch.argmax(b))
        if g != c:
            apart.append(dict(step=i, card=g, cpu=c, cpu_gap=float(b[c] - b[g]),
                              same_head_row=(g - c) % 256 == 0))
    res = {"phase": phase, **info, "decode_steps": GEMMA_CHECK_STEPS,
           "logits_nmse_max": max(errs), "logits_nmse_by_step": errs, "tolerance": 1e-3,
           "logits_rms_diff_by_step": rms, "argmax_agree": f"{len(errs) - len(apart)}/{len(errs)}",
           "picked_apart": apart, "tie_gap": tie_gap,
           "gpu_launches": {n: c for n, c in launched.items() if c},
           "finite": bool(torch.isfinite(gpu["logits"]).all()),
           "waited_for_cpu_s": waited, "seconds": time.perf_counter() - t0, "card": card}
    emit(res)
    if not res["finite"] or max(errs) > 1e-3:
        fail(f"{name}: GPU logits disagree with the CPU plain forward: {res}")
    if tie_gap is not None and any(d["cpu_gap"] >= tie_gap for d in apart):
        fail(f"{name}: the card's greedy tokens differ from the CPU's beyond a tie: {res}")
    if not all(launched[n] for n in must):
        fail(f"{name}: the card's run launched {res['gpu_launches']}, not {must}")
    return launched


def gemma_2layer_check(torch, kernels: dict, card: str, name: str) -> dict:
    """Group 9's 2-layer check (`two_layer_check`): a Gemma geometry, a
    prompt past the window, K2 and K6 launched in their d 256 forms."""
    shape, label = main_shapes()[name]
    info = {"model": f"{label} Q4_K (random weights, seed 0)",
            "window": shape["sliding_window"], "window_note": (
                f"set to {GEMMA2_CHECK_WINDOW} for this check (the model's 4096)"
                if shape["arch"] == "gemma2" else "the model's"),
            "prompt_tokens": GEMMA_CHECKS[name]}
    return two_layer_check(torch, kernels, card, name, phase="gemma_2layer", info=info,
                           must=("attn_decode_qkv", "flash_attention"))


def gemma_kernel_lines(torch, F, model2, gen2, model1, card: str, paths: dict) -> list[dict]:
    """The d 256 forms at their paths' shapes, each against its plain
    version and one SDPA call: K2 over a Gemma-2-2B step's 8 layers (B 1,
    S 4352, every other layer windowed at 4096, the last decode position),
    K6 over its last prefill chunk's (T 256 from 4096), K9 and K10 over the
    Gemma-2B serve steps' 18 layers (4 slots, 16 pages of 128, 8 / 1 heads,
    bf16 pools; K9 rows at 255, 0, 300 and a trash row; K10 a chunk of 128
    from 0, 256, 300 and an idle row)."""
    from zllm_torch.models.llama import _layer_rope, _layer_window
    from zllm_torch.ops import attention as att
    from zllm_torch.ops.layers import rope_table

    g = torch.Generator(device="cuda")
    g.manual_seed(25)

    def randn(*shape_, dtype=torch.float32):
        return torch.randn(*shape_, generator=g, device="cuda").to(dtype)

    def by_path(name):
        return {p: c.get(name, 0) for p, c in paths.items()}

    def agree(a, b):
        return nmse(a.float(), b.float()), float((a.float() - b.float()).abs().max())

    lines = []
    cfg = model2.cfg
    L, hq, hkv, d = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = cfg.attn_scale
    kcs, vcs = gen2.kv.k, gen2.kv.v  # the generate's caches, [1, Hkv, 4352, 256] bf16
    s = kcs[0].shape[2]
    windows = [_layer_window(cfg, il) for il in range(L)]

    # K2: one decode step (its q/k/v rows random, the caches the generate's)
    pos_v = GEMMA2_PROMPT + NEW_TOKENS - 1
    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    lines.append(_k2_line(torch, F, att, name="attn_decode_qkv_d256", cfg=cfg, kcs=kcs,
                          vcs=vcs, pos_v=pos_v, randn=randn, by_path=by_path,
                          ropes=[rope_table(pos, _layer_rope(cfg, il), d) for il in range(L)],
                          windows=windows, unit="one Gemma-2-2B decode step"))

    # K6: the generate's last prefill chunk (T 256 from 4096), its caches
    def visible(p_, w):
        return min(p_, s - 1) + 1 - (max(p_ - w + 1, 0) if w else 0)

    cols = torch.arange(s, device="cuda")
    t6, p6 = CHUNK, (GEMMA2_PROMPT // CHUNK) * CHUNK
    pos6 = (p6 + torch.arange(t6, dtype=torch.int32, device="cuda"))[None]
    q6 = randn(1, t6, hq, d)
    kw6 = dict(scale=scale, softcap=cfg.attn_logit_softcap)
    a = att.flash_attention(q6, kcs[0], vcs[0], pos6, window=windows[0], **kw6)
    b = att.flash_attention_plain(q6, kcs[0], vcs[0], pos6, window=windows[0], **kw6)
    e6, m6 = agree(a, b)

    def k6(fn):
        def go():
            for il in range(L):
                fn(q6, kcs[il], vcs[il], pos6, window=windows[il], **kw6)
        return go

    q6b = q6.to(torch.bfloat16).transpose(1, 2)
    qp = pos6[0][:, None]
    masks6 = [((cols[None] <= qp) & ((cols[None] > qp - w) if w else True)).reshape(1, 1, t6, s)
              for w in windows]

    def k6_lib():
        for il in range(L):
            F.scaled_dot_product_attention(q6b, kcs[il], vcs[il], attn_mask=masks6[il],
                                           scale=scale, enable_gqa=True)

    pairs = sum(visible(p6 + i, w) for w in windows for i in range(t6))
    seen6 = sum(min(p6 + t6 - 1, s - 1) + 1 - (max(p6 - w + 1, 0) if w else 0) for w in windows)
    b6 = bound_ms(L * 2 * q6.numel() * 4 + 2 * hkv * seen6 * d * 2, 4 * hq * d * pairs, "bf16")
    lines.append(dict(
        name="flash_attention_d256", route="cuda", source="zllm_torch/csrc/flash_attn.cu",
        replaces="zllm/ops/attention.py:33", launches=sum(by_path("flash_attention").values()),
        max_abs_err=m6, nmse=e6, tolerance=1e-5, ms=cuda_ms(k6(att.flash_attention), 10),
        plain_ms=cuda_ms(k6(att.flash_attention_plain), 2), bound_ms=b6[0], bound_by=b6[1],
        library_ms=cuda_ms(k6_lib, 10), library="scaled_dot_product_attention (no softcap)",
        launches_by_path=by_path("flash_attention"),
        unit=f"one Gemma-2-2B prefill chunk ({L} launches)",
        shapes=f"q [1,{t6},{hq},{d}] f32 from {p6}, k/v [1,{hkv},{s},{d}] bf16, windows "
               f"{sorted(set(windows))}"))

    # K9 / K10 at the Gemma-2B serve steps' shapes
    lines += _paged_lines(torch, F, att, model1.cfg, seed=25, randn=randn, by_path=by_path,
                          suffix="d256", label="Gemma-2B")
    for ln in lines:
        emit({"phase": "kernel_gemma", "card": card, **ln})
    bad = [ln["name"] for ln in lines if not ln["nmse"] <= ln["tolerance"]]
    if bad:
        fail(f"the d 256 forms disagree with their plain versions: {bad}")
    return lines


def gemma_group(torch, kernels: dict, card: str) -> dict:
    """Group 9: the 2-layer GPU-vs-CPU checks, then Gemma-2-2B's generate
    at 8 layers, Gemma-3-4B's (12 layers) and its ring serve, Gemma-2B
    behind the server, and the d 256 forms' kernel lines.  Returns the
    paths' launch counts and the kernel lines."""
    import torch.nn.functional as F

    from zllm_torch.models.loader import Model

    t0 = time.perf_counter()
    counts = {name: gemma_2layer_check(torch, kernels, card, name) for name in GEMMA_CHECKS}

    def load(name):
        path, _ = gguf_file(name, main_shapes()[name][0], "Q4_K_M")
        return Model.load(str(path), device="cuda", dtype=torch.bfloat16)

    m2 = load("gemma2_2b")
    _, counts["gemma2_2b"], gen2, *_ = main_path(
        torch, "Q4_K_M", kernels, unfused_want(kernels, m2), card, name="gemma2_2b", model=m2,
        prompt_tokens=GEMMA2_PROMPT, max_len=GEMMA2_MAX_LEN)
    m3 = load("gemma3_4b")
    emit({"phase": "gemma3_depth", "layers": m3.cfg.n_layers, "of": 34,
          "windowed": [il for il in range(m3.cfg.n_layers) if m3.cfg.is_swa_layer(il)],
          "note": "Gemma-3-4B's geometry cut to 12 of its 34 layers: two full layers (5, 11)"})
    _, counts["gemma3_4b"], gen3, *_ = main_path(
        torch, "Q4_K_M", kernels, unfused_want(kernels, m3), card, name="gemma3_4b", model=m3,
        prompt_tokens=GEMMA3_PROMPT, max_len=GEMMA3_MAX_LEN)
    del gen3
    counts["serve_ring_gemma3"] = serve_phase(
        torch, m3, kernels, card, label=main_shapes()["gemma3_4b"][1] + " Q4_K_M",
        gemms=gemm_counts(m3), tag="gemma3", server_kw={"max_len": GEMMA3_SERVE_MAX_LEN},
        long_bytes=GEMMA3_LONG_BYTES)
    del m3
    m1 = load("gemma_2b")
    counts["serve_gemma_2b"] = serve_phase(torch, m1, kernels, card,
                                           label="Gemma-2B geometry Q4_K_M",
                                           gemms=gemm_counts(m1), tag="gemma_2b")
    lines = gemma_kernel_lines(torch, F, m2, gen2, m1, card, counts)
    del m1, m2, gen2
    torch.cuda.empty_cache()
    emit({"phase": "gemma_group", "seconds": time.perf_counter() - t0, "card": card})
    return {"counts": counts, "lines": lines}


def gemma_phases():
    """`python3 chip_smoke.py --gemma`: group 9 alone after building the
    kernels (the Gemma files made by children meanwhile)."""
    torch, card = setup_card()
    from zllm_torch.ops import cuda

    t0 = time.perf_counter()
    reports = cuda.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "built": sorted(reports)})
    start_gemma_children()
    kernels = kernel_wrappers()
    gemma_group(torch, kernels, card)
    print(card, flush=True)


# ---- group 10: mixture-of-experts models, K7 at head_dim 256 ----------------

def expert_launches(routing) -> dict:
    """The K3 and K5 launches the recorded routing implies (`moe_ffn.routing`
    entries: layer, the experts used, ...): each quantized stack of the
    layer (gate|up or gate and up, down) once an expert used, K3 for the
    nibble formats, K5 for the others; a dense stack launches none, nor
    does one that zllm's kernels would not take (`qmm.supports`)."""
    from zllm_torch.ops import qmatmul as qmm
    from zllm_torch.quant.repack import QWeightE

    out = {"q4k_gemm": 0, "dequant_gemm": 0}
    for layer, used, *_ in routing:
        for key in ("ffn_gateup_exps", "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
            w = layer.get(key)
            # a stack the kernels do not take (gpt-oss's K 2880) is dequantized
            if isinstance(w, QWeightE) and qmm.supports(w.expert(0)):
                out["q4k_gemm" if w.fmt in qmm.NIBBLE_FMT_CODE else "dequant_gemm"] += len(used)
    return out


def moe_want(kernels: dict, model, n_steps: int, n_chunks: int, routing) -> dict:
    """An MoE generate's launches over the plain stripe: each quantized
    dense weight (attention, a quantized router or shared expert, the head)
    once a decode step (K1 / K4) and once a chunk (K3 / K5), K2 a layer a
    step and a chunk (column 0), K6 a layer a chunk, and the experts' K3 /
    K5 from the routing recorded over the same window."""
    g, L = gemm_counts(model), model.cfg.n_layers
    ex = expert_launches(routing)
    return dict({name: 0 for name in kernels}, q4k_matvec=g["q4k_gemm"] * n_steps,
                int8_matvec=g["dequant_gemm"] * n_steps,
                q4k_gemm=g["q4k_gemm"] * n_chunks + ex["q4k_gemm"],
                dequant_gemm=g["dequant_gemm"] * n_chunks + ex["dequant_gemm"],
                attn_decode_qkv=L * (n_steps + n_chunks), flash_attention=L * n_chunks)


def _layer_of(model, layer) -> int:
    return next(il for il, lay in enumerate(model.params["layers"]) if lay is layer)


def _routing_rows(torch, model, routing) -> list[dict]:
    """Each recorded moe_ffn call as (layer, picks [T, k], the k-th to
    (k+1)-th router probability gap [T]) on the host."""
    k = model.cfg.moe.n_experts_used
    out = []
    for layer, _, picks, probs in routing:
        top = torch.topk(probs.float(), k + 1, dim=-1).values
        out.append(dict(layer=_layer_of(model, layer), picks=picks.reshape(-1, k).tolist(),
                        gap=(top[:, k - 1] - top[:, k]).cpu().tolist()))
    return out


def _moe_2layer_run(torch, name: str, dev: str, forced=None) -> dict:
    """One side of a 2-layer MoE check on `dev` (bf16 weights and KV): the
    MOE_CHECK_PROMPT-token prompt (gpt-oss's: OSS_CHECK_PROMPT, past its
    window) as one chunk (the last token's logits), then MOE_CHECK_STEPS
    decode steps fed this side's argmax (the CPU) or `forced` (the card: the
    CPU's tokens).  Returns the ids, the fed tokens, the logits, every
    moe_ffn call's picks and gaps, and the kernel launches the run implies
    (`moe_want` over the recorded routing)."""
    from zllm_torch.models.llama import forward, moe_ffn
    from zllm_torch.models.loader import Model
    from zllm_torch.runtime.kvcache import KVCache

    path, _ = gguf_file(name, main_shapes()[name][0], CHECK_FTYPES.get(name, "Q4_K_M"))
    m = Model.load(str(path), device=dev, dtype=torch.bfloat16)
    cfg = m.cfg
    prompt_n = CHECK_PROMPTS.get(name, MOE_CHECK_PROMPT)
    ids = prompt_ids(m.tokenizer, prompt_n)
    kv = KVCache.create(cfg.n_layers, 1, prompt_n + CHUNK, cfg.n_kv_heads, cfg.head_dim,
                        torch.bfloat16, dev)

    def run(toks, start):
        tt = torch.tensor([toks], dtype=torch.int32, device=dev)
        pp = torch.arange(start, start + len(toks), dtype=torch.int32, device=dev)[None]
        with torch.inference_mode():
            return forward(m.params, cfg, tt, pp, kv, logits_for="last")[0, -1].float().cpu()

    moe_ffn.routing = []
    try:
        logits, fed = [run(ids, 0)], []
        for i in range(MOE_CHECK_STEPS):
            fed.append(int(torch.argmax(logits[-1])) if forced is None else forced[i])
            logits.append(run([fed[-1]], prompt_n + i))
        routing = _routing_rows(torch, m, moe_ffn.routing)
        want = moe_want(kernel_wrappers(), m, MOE_CHECK_STEPS, 1, moe_ffn.routing)
    finally:
        moe_ffn.routing = None
    if dev == "cuda":
        torch.cuda.synchronize()
    return {"ids": ids, "fed": fed, "logits": torch.stack(logits), "routing": routing,
            "want": want}


def moe_cpu_reference(name: str):
    """`chip_smoke.py --moe-cpu NAME` (a child, niced, on two threads, so
    that the card's host-paced phases keep the cores): the CPU's plain side
    of a 2-layer MoE check, saved for `moe_2layer_check`; it makes the file
    too."""
    import torch

    torch.set_num_threads(4 if name == OSS_CHECK else 2)  # gpt-oss's bf16 experts: 4

    out = CACHE / f"{name}_cpu_reference.pt"
    ref = _moe_2layer_run(torch, name, "cpu")
    _write_atomic(out, lambda p: torch.save(ref, str(p)))


def start_moe_children():
    """The Qwen3-30B-A3B file's child and the 2-layer checks' CPU sides
    (each writes its file), all niced."""
    import atexit

    prepare_requantized([(MOE_MAIN, ("Q4_K_M",))])
    for name in MOE_CHECKS:
        _CPU_CHECKS[name] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--moe-cpu", name], cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: [c.kill() for c in _CPU_CHECKS.values() if c.poll() is None])


def moe_2layer_check(torch, kernels: dict, card: str, name: str, *, must=("q4k_gemm",),
                     tie_gap: float | None = None, phase: str = "moe_2layer") -> dict:
    """2 layers at an MoE model's full width, Q4_K_M (the factory's; gpt-oss:
    MXFP4 experts, Q8_0 elsewhere), bf16: the card against the CPU's plain
    forward (its child's saved logits and routing), the CPU's tokens fed to
    both.  Every token whose picks differ is reported with the CPU's k-th to
    (k+1)-th router score gap (a probability; gpt-oss's softmax_weight: a raw
    logit), which must be below MOE_TIE_GAP; the logits of every step before
    the first such token within nmse 1e-3; the kernels `must` launched
    (K3 for the experts), every count as the recorded routing implies; with
    `tie_gap` (gpt-oss: LN_TIE_GAP) each step whose card argmax is
    not the CPU's passes only where the CPU scores the two picks less than
    `tie_gap` apart."""
    shape, label = main_shapes()[name]
    t0 = time.perf_counter()
    child = _CPU_CHECKS.pop(name)
    err = child.communicate(timeout=1200)[1]
    if child.returncode != 0:
        fail(f"{name}: the CPU reference failed: {err[-2000:]}")
    cpu = torch.load(str(CACHE / f"{name}_cpu_reference.pt"))
    waited = time.perf_counter() - t0
    before = {n: fn.launches for n, fn in kernels.items()}
    gpu = _moe_2layer_run(torch, name, "cuda", forced=cpu["fed"])
    launched = {n: fn.launches - before[n] for n, fn in kernels.items()}
    if gpu["ids"] != cpu["ids"] or len(gpu["routing"]) != len(cpu["routing"]):
        fail(f"{name}: the card's ids or moe_ffn calls differ from the CPU's")
    errs = [nmse(a, b) for a, b in zip(gpu["logits"], cpu["logits"])]
    rms = [float((a - b).pow(2).mean().sqrt()) for a, b in zip(gpu["logits"], cpu["logits"])]
    agree = sum(int(torch.argmax(a)) == int(torch.argmax(b))
                for a, b in zip(gpu["logits"], cpu["logits"]))
    apart = []
    for i, (a, b) in enumerate(zip(gpu["logits"], cpu["logits"])):
        g, c = int(torch.argmax(a)), int(torch.argmax(b))
        if g != c:
            apart.append(dict(step=i, card=g, cpu=c, cpu_gap=float(b[c] - b[g]),
                              same_head_row=(g - c) % 256 == 0))
    n_layers = shape["n_layers"]
    differ = []
    for c, (g, r) in enumerate(zip(gpu["routing"], cpu["routing"])):
        for t, (pg, pc) in enumerate(zip(g["picks"], r["picks"])):
            if sorted(pg) != sorted(pc):
                differ.append(dict(step=c // n_layers, layer=r["layer"], token=t, card=pg,
                                   cpu=pc, cpu_gap=r["gap"][t]))
    first = min([d["step"] for d in differ], default=len(errs))
    ftype = CHECK_FTYPES.get(name, "Q4_K_M")
    res = {"phase": phase, "model": f"{label} {ftype} (random weights, seed 0)",
           "prompt_tokens": CHECK_PROMPTS.get(name, MOE_CHECK_PROMPT),
           "decode_steps": MOE_CHECK_STEPS,
           "logits_nmse_by_step": errs, "logits_nmse_max_before_a_pick_differs":
               max(errs[:first], default=0.0), "tolerance": 1e-3,
           "logits_rms_diff_by_step": rms, "argmax_agree": f"{agree}/{len(errs)}",
           "picked_apart": apart, "tie_gap": tie_gap,
           "launches_expected": gpu["want"], "picks_differ": differ,
           "tie_gap_bound": MOE_TIE_GAP, "gpu_launches": {n: c for n, c in launched.items() if c},
           "finite": bool(torch.isfinite(gpu["logits"]).all()),
           "waited_for_cpu_s": waited, "seconds": time.perf_counter() - t0, "card": card}
    emit(res)
    if not res["finite"] or res["logits_nmse_max_before_a_pick_differs"] > 1e-3:
        fail(f"{name}: GPU logits disagree with the CPU plain forward: {res}")
    if any(d["cpu_gap"] >= MOE_TIE_GAP for d in differ):
        fail(f"{name}: the card picked other experts than the CPU where no tie explains it")
    if tie_gap is not None and any(d["cpu_gap"] >= tie_gap for d in apart if d["step"] < first):
        fail(f"{name}: the card's greedy tokens differ from the CPU's beyond a tie: {res}")
    if not all(launched[n] for n in must) or (tie_gap is not None and launched != gpu["want"]):
        fail(f"{name}: the card's run launched {res['gpu_launches']}, not {must}, or not the "
             f"counts its routing implies {gpu['want']}")
    return launched


def moe_main_path(torch, kernels: dict, card: str, name: str = MOE_MAIN,
                  ftype: str = "Q4_K_M"):
    """Qwen3-30B-A3B (MOE_LAYERS layers; or gpt-oss-20b's `name`, OSS_LAYERS
    layers) through the Generator: the prompt in chunks, then NEW_TOKENS -
    1 decode steps, the launch counts against the routing recorded over the
    same window (K2 and K6 all in their sinks form where the layers have
    sinks; the dequantized matmuls counted apart); one decode step profiled
    eagerly (a CUDA graph cannot capture the per-layer host read of the
    picks), its wall time, and the host read alone.  Returns the model,
    the counts, the generator, the ids, the tokens and the expert launches
    (`expert_launches`)."""
    from zllm_torch.models.llama import forward, moe_ffn
    from zllm_torch.models.loader import Model
    from zllm_torch.ops import attention as att
    from zllm_torch.ops.linear import dequant_linear
    from zllm_torch.runtime.generate import Generator

    shape, label = main_shapes()[name]
    path, t_gguf = gguf_file(name, shape, ftype)
    t0 = time.perf_counter()
    model = Model.load(str(path), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    cfg = model.cfg
    gen = Generator(model, max_len=MAX_LEN, prefill_chunk=CHUNK, kv_dtype=torch.bfloat16)
    ids = prompt_ids(model.tokenizer, PROMPT_TOKENS)
    gen.generate(ids[:CHUNK + 8], max_new=4)  # warm-up: both chunk shapes, decode
    gen.reset()
    for fn in kernels.values():
        fn.launches = 0
    sinks_fns = (att.attn_decode_qkv, att.flash_attention)
    for fn in sinks_fns:
        fn.sinks_launches = 0
    dq0 = dequant_linear.calls
    moe_ffn.routing = []
    try:
        res = gen.generate(ids, max_new=NEW_TOKENS)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in kernels.items()}
        routing = moe_ffn.routing
    finally:
        moe_ffn.routing = None
    dequant_calls = dequant_linear.calls - dq0
    sinks = {fn.__name__: fn.sinks_launches for fn in sinks_fns}
    has_sinks = "attn_sinks" in model.params["layers"][0]
    sinks_expected = {k: counts[k] if has_sinks else 0 for k in sinks}
    n_chunks, n_steps = -(-PROMPT_TOKENS // CHUNK), len(res.tokens) - 1
    expected = moe_want(kernels, model, n_steps, n_chunks, routing)
    used = [len(u) for _, u, *_ in routing]
    tok_t = torch.tensor([[res.tokens[-1]]], dtype=torch.int32, device="cuda")
    pos_t = torch.tensor([[PROMPT_TOKENS + n_steps]], dtype=torch.int32, device="cuda")

    def step():
        with torch.inference_mode():
            return forward(model.params, cfg, tok_t, pos_t, gen.kv, logits_for="last")

    last_logits = step()[0, -1].float()
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t1))
    profile_ = step_profile(torch, step)
    picks = torch.zeros((1, cfg.moe.n_experts_used), dtype=torch.int64, device="cuda")
    reads = []
    for _ in range(200):  # the host read alone, the card idle: its round trip
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        picks.cpu()
        reads.append(1e3 * (time.perf_counter() - t1))
    host_read_ms = sorted(reads)[len(reads) // 2]
    emit({"phase": "main_path", "model": f"{label} {ftype} (random weights, seed 0)",
          "shape": {k: str(v) if k == "expert_gtype" else v for k, v in shape.items()},
          "dtype": "bfloat16", "kv_dtype": "bfloat16",
          "prompt_tokens": PROMPT_TOKENS, "max_len": MAX_LEN, "prefill_chunks": n_chunks,
          "new_tokens": len(res.tokens), "prefill_tok_s": PROMPT_TOKENS / res.t_prefill,
          "decode_tok_s": n_steps / res.t_decode, "t_prefill_s": res.t_prefill,
          "t_decode_s": res.t_decode, "gguf_build_s": t_gguf, "load_s": t_load,
          "launches": counts, "launches_expected": expected,
          "sinks_launches": sinks, "sinks_launches_expected": sinks_expected,
          "dequant_matmuls": dequant_calls,
          "dense_dequant_matmuls_per_forward": dequant_calls and (
              dequant_calls - sum(2 * len(u) for _, u, *_ in routing)) / (n_steps + n_chunks),
          "expert_launches": expert_launches(routing),
          "experts_used_per_call": {"decode_step_mean": sum(used[-cfg.n_layers * n_steps:])
                                    / (cfg.n_layers * n_steps), "chunks": used[:cfg.n_layers
                                                                             * n_chunks]},
          "step_graph_ms": "not measured: moe_ffn reads each layer's picks on the host, which "
                           "a CUDA graph capture cannot hold",
          "step_eager_wall_ms": sorted(walls)[len(walls) // 2], "step_profile": profile_,
          "host_reads_per_step": cfg.n_layers, "host_read_ms": host_read_ms,
          "host_reads_ms_per_step": cfg.n_layers * host_read_ms, "card": card})
    if n_steps != NEW_TOKENS - 1:
        fail(f"{name}: generate stopped after {len(res.tokens)} tokens")
    if counts != expected:
        fail(f"{name}: kernel launch counts {counts} != expected {expected}")
    if sinks != sinks_expected:
        fail(f"{name}: sinks-form launches {sinks} != expected {sinks_expected}")
    if last_logits.shape != (cfg.vocab_size,) or not bool(torch.isfinite(last_logits).all()):
        fail(f"{name}: logits are not finite or have the wrong shape")
    return model, counts, gen, ids, res.tokens, expert_launches(routing)


def moe_kernel_lines(torch, model, gen, ids: list, tokens: list, experts: dict,
                     card: str) -> list[dict]:
    """K3 and K5 over the expert calls of one decode step and of one chunk
    of the Qwen3-30B-A3B model (recorded by wrapping moe_ffn's product),
    each against its plain version, torch.matmul on the experts dequantized
    to bf16 outside the timing, and its bound: the picked experts' GGUF
    bytes (each read once) plus the rows in and out over 3.35 TB/s, or
    2 * M * K * N over 989 TFLOP/s."""
    from zllm_torch.models import llama
    from zllm_torch.ops import qmatmul as qmm
    from zllm_torch.quant.repack import QWeightE

    calls = {"chunk": [], "decode_step": []}
    real = llama._expert_mm
    where = []

    def spy(x, w, e):
        if isinstance(w, QWeightE):
            calls[where[-1]].append((x.contiguous().clone(), w.expert(e)))
        return real(x, w, e)

    with mock.patch.object(llama, "_expert_mm", spy):
        gen.reset()
        where.append("chunk")
        gen.prefill(ids[:CHUNK])
        where.append("decode_step")
        gen._decode_one(tokens[0], CHUNK)
    torch.cuda.synchronize()

    def case(fn, plain, sub) -> dict:
        outs = [fn(x, w) for x, w in sub]
        ref = [plain(x, w) for x, w in sub]
        a, b = torch.cat([o.reshape(-1) for o in outs]), torch.cat([r.reshape(-1) for r in ref])
        # outside the timing: the experts dequantized, the rows in bf16
        dense = {id(w): w.dequant(torch.bfloat16) for _, w in sub}
        xb = [x.to(torch.bfloat16) for x, _ in sub]

        def run(f):
            def go():
                for x, w in sub:
                    f(x, w)
            return go

        def lib():
            for x, (_, w) in zip(xb, sub):
                torch.matmul(x, dense[id(w)])

        wbytes = sum(w.shape[0] * w.shape[1] * GGUF_BYTES_PER_WEIGHT[w.fmt.name]
                     for w in {id(w): w for _, w in sub}.values())
        io = sum(x.numel() * x.element_size() + 4 * x.shape[0] * w.shape[1] for x, w in sub)
        ops = sum(2 * x.shape[0] * w.shape[0] * w.shape[1] for x, w in sub)
        bms, bby = bound_ms(wbytes + io, ops, "bf16")
        rows = sorted({x.shape[0] for x, _ in sub})
        out = dict(ms=cuda_ms(run(fn), 10), plain_ms=cuda_ms(run(plain), 1),
                   library_ms=cuda_ms(lib, 10), bound_ms=bms, bound_by=bby, nmse=nmse(a, b),
                   max_abs_err=float((a - b).abs().max()), tolerance=1e-6, calls=len(sub),
                   experts=len(dense), rows_min=rows[0], rows_max=rows[-1])
        del dense, xb
        return out

    lines = []
    for name, fn, src, rep, fmts in (
            ("q4k_gemm_experts", qmm.q4k_gemm, "zllm_torch/csrc/q4k_gemm.cu",
             "zllm/ops/qmatmul.py:1402", qmm.NIBBLE_FMT_CODE),
            ("dequant_gemm_experts", qmm.dequant_gemm, "zllm_torch/csrc/dequant_gemm.cu",
             "zllm/ops/qmatmul.py:1542", qmm.INT8_FMT_CODE)):
        by = {ph: [(x, w) for x, w in c if w.fmt in fmts] for ph, c in calls.items()}
        step, chunk = case(fn, qmm.dequant_gemm_plain, by["decode_step"]), case(
            fn, qmm.dequant_gemm_plain, by["chunk"])
        lines.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=experts[fn.__name__],
            **{k: step[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "nmse", "max_abs_err", "tolerance")},
            library="torch.matmul on the experts dequantized to bf16 outside the timing",
            unit=f"one Qwen3-30B-A3B decode step's expert calls ({step['calls']})",
            decode_step=step, chunk=chunk,
            note="zllm runs its experts as XLA einsums (zllm/models/llama.py:159, moe_ffn); "
                 "the port runs them on this kernel at every M; launches: the main path's "
                 "expert launches"))
    for ln in lines:
        emit({"phase": "kernel_moe", "card": card, **ln})
    bad = [f"{ln['name']} {ph}" for ln in lines for ph in ("decode_step", "chunk")
           if not ln[ph]["nmse"] <= ln[ph]["tolerance"]]
    if bad:
        fail(f"the expert GEMMs disagree with their plain versions: {bad}")
    return lines


def k7_case(torch, F, randn, kvs: list, t7: int, starts: list, hq: int, scale: float,
            sinks=None, windows=None) -> dict:
    """K7 over one engine step's layers `kvs` (each layer's k, v [B, Hkv,
    S, D] int8 codes with their f32 scales ks, vs [B, Hkv, S, 1], or bf16
    K/V with None), T = t7 query rows a slot from `starts` (hq heads, f32
    q), each layer's sink logits and window where given (`sinks`,
    `windows`: gpt-oss's), against its plain version and one SDPA call a
    layer on K/V dequantized to bf16 outside the timing (no sink: SDPA
    takes none), with its bound: the slots each row reads (its widest
    query's span) and the (query, slot) pairs the causal mask lets through,
    each query its own span."""
    from zllm_torch.ops import attention as att

    n_slots, hkv, s7, hd = kvs[0][0].shape
    per_layer, int8 = len(kvs), kvs[0][2] is not None
    sinks = sinks or [None] * per_layer
    windows = windows or [0] * per_layer
    pos7 = (torch.tensor(starts, dtype=torch.int32, device="cuda")[:, None]
            + torch.arange(t7, dtype=torch.int32, device="cuda")[None])
    q7 = randn(n_slots, t7, hq, hd)
    k_, v_, ks_, vs_ = kvs[0]
    extra = dict(sinks=sinks[0], window=windows[0])
    a = att.flash_attention_blockwise(q7, k_, v_, pos7, scale=scale, ks=ks_, vs=vs_, **extra)
    b = att.flash_attention_blockwise_plain(q7, k_, v_, pos7, scale=scale, ks=ks_, vs=vs_,
                                            **extra)

    def run(fn):
        def go():
            for (k_, v_, ks_, vs_), sk, w in zip(kvs, sinks, windows):
                fn(q7, k_, v_, pos7, scale=scale, ks=ks_, vs=vs_, sinks=sk, window=w)
        return go

    def bf16(x, sc):
        return x if sc is None else (x.float() * sc).to(torch.bfloat16)

    deq = [(bf16(k_, ks_), bf16(v_, vs_)) for k_, v_, ks_, vs_ in kvs]
    q7b = q7.to(torch.bfloat16).transpose(1, 2)
    cols = torch.arange(s7, device="cuda")[None, None, :]
    masks = {w: ((cols <= pos7[:, :, None]) & ((cols > pos7[:, :, None] - w) if w else True))
             .reshape(n_slots, 1, t7, s7) for w in set(windows)}

    def lib():
        for (k_, v_), w in zip(deq, windows):
            F.scaled_dot_product_attention(q7b, k_, v_, attn_mask=masks[w], scale=scale,
                                           enable_gqa=True)

    def lo(p_, w):  # a query's first visible slot
        return max(p_ - w + 1, 0) if w else 0

    seen = sum(min(p_ + t7 - 1, s7 - 1) + 1 - lo(p_, w) for w in windows for p_ in starts)
    pairs = sum(min(p_ + t, s7 - 1) + 1 - lo(p_ + t, w) for w in windows for p_ in starts
                for t in range(t7))
    slot_bytes = 2 * hkv * (hd + 4) if int8 else 2 * hkv * hd * 2
    nbytes = seen * slot_bytes + per_layer * 2 * q7.numel() * 4
    bms, bby = bound_ms(nbytes, 4 * hq * hd * pairs, "bf16")
    reps = 20 if t7 == 1 else 5
    return dict(ms=cuda_ms(run(att.flash_attention_blockwise), reps),
                plain_ms=cuda_ms(run(att.flash_attention_blockwise_plain), 2),
                library_ms=cuda_ms(lib, reps), bound_ms=bms, bound_by=bby,
                nmse=nmse(a, b), max_abs_err=float((a - b).abs().max()), tolerance=1e-6,
                shapes=f"q [{n_slots},{t7},{hq},{hd}] f32 from {starts}, k/v "
                       f"[{n_slots},{hkv},{s7},{hd}] " + (
                           "int8 + f32 scales [.., 1]" if int8 else "bf16"))


def k7_d256_line(torch, F, model, card: str, counts: dict) -> dict:
    """K7's d 256 forms at the Gemma-2B q8 serve's shapes (4 slots, S 2176,
    8 / 1 heads of 256, 18 layers): a decode step (rows at 255, 0, 300 and a
    trash row at 2048) and a mixed step (a chunk of 128 from 0, 256, 300
    and 2048), over int8 codes with f32 scales and over bf16 K/V
    (`k7_case`)."""
    cfg = model.cfg
    L, hq, hkv, d, n_slots, s7 = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 4, \
        MAX_LEN + 128
    scale = cfg.attn_scale or d ** -0.5
    g = torch.Generator(device="cuda")
    g.manual_seed(26)

    def randn(*shape_, dtype=torch.float32):
        return torch.randn(*shape_, generator=g, device="cuda").to(dtype)

    def codes():
        return torch.randint(-127, 128, (n_slots, hkv, s7, d), generator=g, device="cuda",
                             dtype=torch.int8)

    kvs = {"int8": [(codes(), codes(), randn(n_slots, hkv, s7, 1).abs() * 0.01 + 1e-3,
                     randn(n_slots, hkv, s7, 1).abs() * 0.01 + 1e-3) for _ in range(L)],
           "bf16": [(randn(n_slots, hkv, s7, d, dtype=torch.bfloat16),
                     randn(n_slots, hkv, s7, d, dtype=torch.bfloat16), None, None)
                    for _ in range(L)]}
    dec, mix = [255, 0, 300, MAX_LEN], [0, 256, 300, MAX_LEN]
    k7 = {f"{form}_{step}": k7_case(torch, F, randn, kvs[form], t7, starts, hq, scale)
          for form in ("int8", "bf16") for step, t7, starts in (("decode", 1, dec),
                                                                  ("mixed", 128, mix))}
    del kvs
    head = k7["int8_decode"]
    line = dict(name="flash_attention_blockwise_d256", route="cuda",
                source="zllm_torch/csrc/attn_blockwise.cu", replaces="zllm/ops/attention.py:165",
                launches=counts["flash_attention_blockwise"], mma_launches=counts["mma_launches"],
                **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "nmse", "max_abs_err", "tolerance", "shapes")},
                library="scaled_dot_product_attention on K/V dequantized to bf16 outside the "
                        "timing",
                unit=f"one Gemma-2B serve_q8 decode step ({L} launches), int8 K/V",
                serve_q8_mixed_step=k7["int8_mixed"], bf16_decode_step=k7["bf16_decode"],
                bf16_mixed_step=k7["bf16_mixed"], head_dim=d,
                form="split (R <= 32): decode_cluster.cuh's D 256 instantiation; mixed: "
                     "attn_mma.cuh in chunks of 64 slots")
    emit({"phase": "kernel_moe", "card": card, **line})
    bad = [k for k, r in k7.items() if not r["nmse"] <= r["tolerance"]]
    if bad:
        fail(f"K7's d 256 forms disagree with their plain versions: {bad}")
    return line


def moe_group(torch, kernels: dict, card: str) -> dict:
    """Group 10: Qwen3-30B-A3B's generate and serve with the expert lines,
    Gemma-2B on the q8 cache with K7's d 256 line, then the 2-layer
    Mixtral and Qwen1.5-MoE checks against the CPU.  Returns the paths'
    launch counts and the kernel lines."""
    import torch.nn.functional as F

    from zllm_torch.models.loader import Model

    t0 = time.perf_counter()
    model, counts_main, gen, ids, tokens, experts = moe_main_path(torch, kernels, card)
    label = main_shapes()[MOE_MAIN][1] + " Q4_K_M"
    counts = {MOE_MAIN: counts_main,
              "serve_qwen3_30b_a3b": serve_phase(torch, model, kernels, card, label=label,
                                                 gemms=gemm_counts(model), tag=MOE_MAIN)}
    lines = moe_kernel_lines(torch, model, gen, ids, tokens, experts, card)
    del model, gen
    torch.cuda.empty_cache()
    path, _ = gguf_file("gemma_2b", main_shapes()["gemma_2b"][0], "Q4_K_M")
    m1 = Model.load(str(path), device="cuda", dtype=torch.bfloat16)
    counts["serve_q8_gemma_2b"] = serve_phase(torch, m1, kernels, card, kv_dtype="q8",
                                              label="Gemma-2B geometry Q4_K_M",
                                              gemms=gemm_counts(m1), tag="gemma_2b")
    lines.append(k7_d256_line(torch, F, m1, card, counts["serve_q8_gemma_2b"]))
    del m1
    torch.cuda.empty_cache()
    for name in MOE_CHECKS:
        counts[name] = moe_2layer_check(torch, kernels, card, name)
        torch.cuda.empty_cache()
    emit({"phase": "moe_group", "seconds": time.perf_counter() - t0, "card": card})
    return {"counts": counts, "lines": lines}


def moe_phases():
    """`python3 chip_smoke.py --moe`: group 10 alone after building the
    kernels (its files and CPU references made by children meanwhile, and
    Gemma-2B's)."""
    torch, card = setup_card()
    from zllm_torch.ops import cuda

    t0 = time.perf_counter()
    reports = cuda.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "built": sorted(reports),
          "attn_blockwise": ptxas_entries({"attn_blockwise": reports.get("attn_blockwise", "")},
                                          "_kernel")})
    start_moe_children()
    prepare_requantized([("gemma_2b", ("Q4_K_M",))])
    kernels = kernel_wrappers()
    moe_group(torch, kernels, card)
    print(card, flush=True)


# ---- group 11: the layer-norm families (gptneox, stablelm, starcoder2) --------

def start_ln_children():
    """Group 11's files (the factory's Q4_K_M preset of Pythia-1.4B and of
    StarCoder2-3B at LN_SERVE_LAYERS layers) and the 2-layer checks' CPU
    sides (each makes its Q4_K file), all niced."""
    import atexit

    prepare_requantized([(LN_MAIN, ("Q4_K_M",)), (LN_SERVE, ("Q4_K_M",))])
    for name in LN_CHECKS:
        _CPU_CHECKS[name] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--ln-cpu", name], cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: [c.kill() for c in _CPU_CHECKS.values() if c.poll() is None])


def ln_2layer_check(torch, kernels: dict, card: str, name: str) -> dict:
    """Group 11's 2-layer check (`two_layer_check`): the same greedy token
    at every step up to LN_TIE_GAP, K1, K2, K3 and K6 launched."""
    shape, label = main_shapes()[name]
    info = {"model": f"{label} Q4_K (random weights, seed 0)", "arch": shape["arch"],
            "rope_dims": shape.get("rope_dim") or shape["head_dim"],
            "head_dim": shape["head_dim"], "gqa_group": shape["n_heads"] // shape["n_kv_heads"],
            "prompt_tokens": LN_CHECK_PROMPT}
    return two_layer_check(torch, kernels, card, name, phase="ln_2layer", info=info,
                           must=("q4k_matvec", "attn_decode_qkv", "q4k_gemm",
                                 "flash_attention"), tie_gap=LN_TIE_GAP)


def _k2_line(torch, F, att, *, name: str, unit: str, cfg, kcs, vcs, pos_v: int, randn,
             by_path, ropes=None, windows=None, sinks=None) -> dict:
    """K2 over one decode step of `cfg`'s geometry (a launch a layer, the
    caches `kcs`/`vcs`, each layer's rope table at `pos_v` (`ropes`, by
    default cfg.rope's) and window (`windows`, by default none), each
    layer's sink logits (`sinks`: the sinks form; by default none), cfg's
    softcap, random q/k/v rows) against its plain version and one SDPA call
    a layer (attention alone; SDPA takes no sink)."""
    from zllm_torch.ops.layers import rope_table

    L, hq, hkv, d = len(kcs), cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = kcs[0].shape[2]
    scale = cfg.attn_scale or d ** -0.5
    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    ropes = ropes or [rope_table(pos, cfg.rope, d)] * L
    windows = windows or [0] * L
    sinks = sinks or [None] * L
    qkv3 = randn(1, hq + 2 * hkv, d)
    kw = dict(scale=scale, softcap=cfg.attn_logit_softcap, eps=cfg.norm_eps)
    a = att.attn_decode_qkv(qkv3, kcs[0].clone(), vcs[0].clone(), pos, ropes[0],
                            window=windows[0], sinks=sinks[0], **kw)
    b = att.attn_decode_qkv_plain(qkv3, kcs[0].clone(), vcs[0].clone(), pos, ropes[0],
                                  window=windows[0], sinks=sinks[0], **kw)
    e, m = nmse(a.float(), b.float()), float((a.float() - b.float()).abs().max())

    def k2(fn):
        def go():
            for il in range(L):
                fn(qkv3, kcs[il], vcs[il], pos, ropes[il], window=windows[il], sinks=sinks[il],
                   **kw)
        return go

    q2b = qkv3[:, :hq, None].to(torch.bfloat16)  # [1, Hq, 1, D]
    cols = torch.arange(s, device="cuda")
    masks = [((cols <= pos_v) & ((cols > pos_v - w) if w else True)).reshape(1, 1, 1, s)
             for w in windows]

    def lib():
        for il in range(L):
            F.scaled_dot_product_attention(q2b, kcs[il], vcs[il], attn_mask=masks[il],
                                           scale=scale, enable_gqa=True)

    seen = sum(min(pos_v, s - 1) + 1 - (max(pos_v - w + 1, 0) if w else 0) for w in windows)
    bd = bound_ms(2 * hkv * seen * d * 2 + L * (qkv3.numel() * 4 + hq * d * 4),
                  4 * hq * d * seen, "bf16")
    return dict(
        name=name, route="cuda", source="zllm_torch/csrc/attn_decode.cu",
        replaces="zllm/ops/attention.py:970", launches=sum(by_path("attn_decode_qkv").values()),
        max_abs_err=m, nmse=e, tolerance=1e-5, ms=cuda_ms(k2(att.attn_decode_qkv), 20),
        plain_ms=cuda_ms(k2(att.attn_decode_qkv_plain), 3), bound_ms=bd[0], bound_by=bd[1],
        library_ms=cuda_ms(lib, 20), library="scaled_dot_product_attention on the caches "
        "(attention alone: q not roped, nothing inserted"
        + (", no softcap: SDPA has none" if cfg.attn_logit_softcap else "")
        + (", no sink: SDPA takes none" if sinks[0] is not None else "") + ")",
        launches_by_path=by_path("attn_decode_qkv"), unit=f"{unit} ({L} launches)",
        shapes=f"qkv3 [1,{hq + 2 * hkv},{d}] f32, caches [1,{hkv},{s},{d}] "
               f"{str(kcs[0].dtype)[6:]} at {pos_v}, {'neox' if ropes[0].neox else 'norm'} rope over "
               f"{ropes[0].rot_dims} of {d} dims, G {hq // hkv}, windows "
               f"{sorted(set(windows))}, softcap {cfg.attn_logit_softcap}")


def _paged_lines(torch, F, att, cfg, *, seed: int, randn, by_path, suffix: str,
                 label: str, shape_note: str = "") -> list[dict]:
    """K9 and K10 at a serve's shapes (`cfg`'s layers and heads, 4 slots of
    MAX_LEN // 128 pages of 128, bf16 pools, a page table of `seed`): K9
    rows at 255, 0, 300 and a trash row, K10 a chunk of 128 from 0, 256,
    300 and an idle row; each against its plain version and one SDPA call a
    layer on the pages gathered outside the timing."""
    L1, hq1, hkv1, d = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale1 = cfg.attn_scale or d ** -0.5
    n_slots, ps, lp = 4, 128, MAX_LEN // 128
    horizon = lp * ps
    table = _paged_table(torch, n_slots, lp, seed)
    pool_shape = (hkv1, (n_slots * lp + 1) * ps, d)
    kpools = [randn(*pool_shape, dtype=torch.bfloat16) for _ in range(L1)]
    vpools = [randn(*pool_shape, dtype=torch.bfloat16) for _ in range(L1)]
    hrange = torch.arange(horizon, device="cuda")
    rows = (table[:, :lp].long()[:, hrange // ps] * ps + hrange % ps).reshape(-1)

    def gathered(pool):
        return pool[:, rows].reshape(hkv1, n_slots, horizon, d).transpose(0, 1).contiguous()

    def agree(a, b):
        return nmse(a.float(), b.float()), float((a.float() - b.float()).abs().max())

    gk, gv = [gathered(p_) for p_ in kpools], [gathered(p_) for p_ in vpools]
    pools = f"pools [{hkv1},{pool_shape[1]},{d}] bf16{shape_note}"
    lines = []

    pos9 = torch.tensor([[255], [0], [300], [horizon]], dtype=torch.int32, device="cuda")
    live = pos9[:, 0] < horizon
    q9, kn9, vn9 = (randn(n_slots, 1, h, d) for h in (hq1, hkv1, hkv1))
    kw9 = dict(page_size=ps, scale=scale1)
    e9, m9 = agree(*(r[live] for r in (
        att.paged_attn_decode_update(q9, kn9, vn9, kpools[0].clone(), vpools[0].clone(), table,
                                     pos9, **kw9),
        att.paged_attn_decode_update_plain(q9, kn9, vn9, kpools[0].clone(), vpools[0].clone(),
                                           table, pos9, **kw9))))

    def k9(fn):
        def go():
            for il in range(L1):
                fn(q9, kn9, vn9, kpools[il], vpools[il], table, pos9, **kw9)
        return go

    q9b = q9.to(torch.bfloat16).transpose(1, 2)
    mask9 = (hrange[None] <= pos9).reshape(n_slots, 1, 1, horizon)

    def k9_lib():
        for il in range(L1):
            F.scaled_dot_product_attention(q9b, gk[il], gv[il], attn_mask=mask9, scale=scale1,
                                           enable_gqa=True)

    seen9 = sum(min(int(p_), horizon - 1) + 1 for p_ in pos9[:, 0].tolist() if p_ < horizon)
    b9 = bound_ms(L1 * (2 * hkv1 * seen9 * d * 2 + 2 * q9.numel() * 4 + 2 * kn9.numel() * 4),
                  L1 * 4 * hq1 * d * seen9, "bf16")
    lines.append(dict(
        name=f"paged_attn_decode_update_{suffix}", route="cuda",
        source="zllm_torch/csrc/paged_decode.cu", replaces="zllm/ops/attention.py:665",
        launches=sum(by_path("paged_attn_decode_update").values()), max_abs_err=m9, nmse=e9,
        tolerance=1e-6, ms=cuda_ms(k9(att.paged_attn_decode_update), 20),
        plain_ms=cuda_ms(k9(att.paged_attn_decode_update_plain), 2), bound_ms=b9[0],
        bound_by=b9[1], library_ms=cuda_ms(k9_lib, 20),
        library="scaled_dot_product_attention on the pages gathered outside the timing",
        launches_by_path=by_path("paged_attn_decode_update"),
        unit=f"one {label} serve decode step ({L1} launches)",
        shapes=f"q [4,1,{hq1},{d}] f32, {pools}, rows at {pos9[:, 0].tolist()}, "
               f"G {hq1 // hkv1}"))

    t10 = 128
    starts = torch.tensor([0, 256, 300, horizon], dtype=torch.int32, device="cuda")
    pos10 = starts[:, None] + torch.arange(t10, dtype=torch.int32, device="cuda")[None]
    q10 = randn(n_slots, t10, hq1, d)
    kw10 = dict(page_size=ps, scale=scale1)
    live10 = starts < horizon
    e10, m10 = agree(*(r[live10] for r in (
        att.paged_attention(q10, kpools[0], vpools[0], table, pos10, **kw10),
        att.paged_attention_plain(q10, kpools[0], vpools[0], table, pos10, **kw10))))

    def k10(fn):
        def go():
            for il in range(L1):
                fn(q10, kpools[il], vpools[il], table, pos10, **kw10)
        return go

    q10b = q10.to(torch.bfloat16).transpose(1, 2)
    mask10 = (hrange[None, None] <= pos10[:, :, None]).reshape(n_slots, 1, t10, horizon)

    def k10_lib():
        for il in range(L1):
            F.scaled_dot_product_attention(q10b, gk[il], gv[il], attn_mask=mask10, scale=scale1,
                                           enable_gqa=True)

    live_starts = [int(p_) for p_ in starts.tolist() if p_ < horizon]
    pairs10 = sum(min(p_ + i, horizon - 1) + 1 for p_ in live_starts for i in range(t10))
    seen10 = sum(min(p_ + t10 - 1, horizon - 1) + 1 for p_ in live_starts)
    b10 = bound_ms(L1 * (2 * hkv1 * seen10 * d * 2 + 2 * q10.numel() * 4),
                   L1 * 4 * hq1 * d * pairs10, "bf16")
    lines.append(dict(
        name=f"paged_attention_{suffix}", route="cuda", source="zllm_torch/csrc/paged_attn.cu",
        replaces="zllm/ops/attention.py:350", launches=sum(by_path("paged_attention").values()),
        max_abs_err=m10, nmse=e10, tolerance=1e-6, ms=cuda_ms(k10(att.paged_attention), 10),
        plain_ms=cuda_ms(k10(att.paged_attention_plain), 2), bound_ms=b10[0], bound_by=b10[1],
        library_ms=cuda_ms(k10_lib, 10),
        library="scaled_dot_product_attention on the pages gathered outside the timing",
        launches_by_path=by_path("paged_attention"),
        unit=f"one {label} serve mixed step ({L1} launches)",
        shapes=f"q [4,{t10},{hq1},{d}] f32 from {starts.tolist()}, {pools}, G {hq1 // hkv1}"))
    return lines


def ln_kernel_lines(torch, F, model_p, gen_p, pos_p: int, model_s, card: str,
                    paths: dict) -> list[dict]:
    """The forms this slice first runs, at its paths' shapes, each against
    its plain version and one SDPA call a layer: K2 over a Pythia-1.4B
    decode step (the generate's caches; neox rope over 32 of 128 dims),
    over a StableLM-2-1.6B one (24 layers of random bf16 caches, S 2048;
    16 of 64) and over a StarCoder2-3B one (30 layers, G 12 at d 128); K6
    over the Pythia prompt's second chunk; K9 and K10 over the StarCoder2
    serve steps' 8 layers (4 slots, 16 pages of 128, 24 / 2 heads), and K7
    over the same steps on a q8 cache (`k7_case`)."""
    from zllm_torch import testing as zt
    from zllm_torch.models.config import ModelConfig
    from zllm_torch.ops import attention as att
    from zllm_torch.ops.layers import RopeParams

    g = torch.Generator(device="cuda")
    g.manual_seed(27)

    def randn(*shape_, dtype=torch.float32):
        return torch.randn(*shape_, generator=g, device="cuda").to(dtype)

    def by_path(name):
        return {p: c.get(name, 0) for p, c in paths.items()}

    def agree(a, b):
        return nmse(a.float(), b.float()), float((a.float() - b.float()).abs().max())

    def geometry(shape, layers=None):
        """A config of the factory `shape`'s heads and rope."""
        return ModelConfig(arch=shape["arch"], n_layers=layers or shape["n_layers"],
                           n_embd=shape["n_embd"], n_heads=shape["n_heads"],
                           n_kv_heads=shape["n_kv_heads"], head_dim=shape["head_dim"],
                           n_ff=shape["n_ff"], vocab_size=shape["vocab_size"],
                           norm_eps=shape["norm_eps"],
                           rope=RopeParams(dim=shape.get("rope_dim") or shape["head_dim"],
                                           base=shape["rope_base"], style="neox"))

    lines = []
    cfg_p = model_p.cfg
    lines.append(_k2_line(torch, F, att, name="attn_decode_qkv_neox_r32", cfg=cfg_p,
                          kcs=gen_p.kv.k, vcs=gen_p.kv.v, pos_v=pos_p, randn=randn,
                          by_path=by_path, unit="one Pythia-1.4B decode step"))
    s = MAX_LEN
    for label, shape, name in (("StableLM-2-1.6B", zt.STABLELM2_1_6B_SHAPE,
                                "attn_decode_qkv_neox_r16_d64"),
                               ("StarCoder2-3B", zt.STARCODER2_3B_SHAPE, "attn_decode_qkv_g12")):
        cfg = geometry(shape)
        kv_shape = (1, cfg.n_kv_heads, s, cfg.head_dim)
        kcs = [randn(*kv_shape, dtype=torch.bfloat16) for _ in range(cfg.n_layers)]
        vcs = [randn(*kv_shape, dtype=torch.bfloat16) for _ in range(cfg.n_layers)]
        lines.append(_k2_line(torch, F, att, name=name, cfg=cfg, kcs=kcs, vcs=vcs, pos_v=pos_p,
                              randn=randn, by_path=by_path,
                              unit=f"one {label} decode step (random caches)"))
        del kcs, vcs

    # K6: the Pythia prompt's second chunk (T 256 from 256) over its caches
    L, hq, hkv, d = cfg_p.n_layers, cfg_p.n_heads, cfg_p.n_kv_heads, cfg_p.head_dim
    kcs, vcs = gen_p.kv.k, gen_p.kv.v
    scale = d ** -0.5
    t6, p6 = CHUNK, CHUNK
    pos6 = (p6 + torch.arange(t6, dtype=torch.int32, device="cuda"))[None]
    q6 = randn(1, t6, hq, d)
    e6, m6 = agree(att.flash_attention(q6, kcs[0], vcs[0], pos6, scale=scale),
                   att.flash_attention_plain(q6, kcs[0], vcs[0], pos6, scale=scale))

    def k6(fn):
        def go():
            for il in range(L):
                fn(q6, kcs[il], vcs[il], pos6, scale=scale)
        return go

    q6b = q6.to(torch.bfloat16).transpose(1, 2)
    cols = torch.arange(kcs[0].shape[2], device="cuda")
    mask6 = (cols[None] <= pos6[0][:, None]).reshape(1, 1, t6, -1)

    def k6_lib():
        for il in range(L):
            F.scaled_dot_product_attention(q6b, kcs[il], vcs[il], attn_mask=mask6, scale=scale)

    pairs = L * sum(p6 + i + 1 for i in range(t6))
    b6 = bound_ms(L * (2 * q6.numel() * 4 + 2 * hkv * (p6 + t6) * d * 2), 4 * hq * d * pairs,
                  "bf16")
    lines.append(dict(
        name="flash_attention_pythia", route="cuda", source="zllm_torch/csrc/flash_attn.cu",
        replaces="zllm/ops/attention.py:33", launches=sum(by_path("flash_attention").values()),
        max_abs_err=m6, nmse=e6, tolerance=1e-5, ms=cuda_ms(k6(att.flash_attention), 10),
        plain_ms=cuda_ms(k6(att.flash_attention_plain), 2), bound_ms=b6[0], bound_by=b6[1],
        library_ms=cuda_ms(k6_lib, 10), library="scaled_dot_product_attention (causal mask)",
        launches_by_path=by_path("flash_attention"),
        unit=f"one Pythia-1.4B prefill chunk ({L} launches)",
        shapes=f"q [1,{t6},{hq},{d}] f32 from {p6}, k/v [1,{hkv},{kcs[0].shape[2]},{d}] bf16, "
               "G 1"))

    # K9 / K10 at the StarCoder2 serve steps' shapes (G 12, d 128)
    cfg_s = model_s.cfg
    L1, hq1, hkv1, d1 = cfg_s.n_layers, cfg_s.n_heads, cfg_s.n_kv_heads, cfg_s.head_dim
    lines += _paged_lines(torch, F, att, cfg_s, seed=27, randn=randn, by_path=by_path,
                          suffix="g12", label=f"StarCoder2-3B ({L1} layers)")
    # K7 at the StarCoder2 serve's shapes over a q8 cache (int8 codes, S
    # 2176): a decode step (G 12: the split form) and a mixed step
    n_slots, scale1, s7 = 4, d1 ** -0.5, MAX_LEN + 128

    def codes():
        return torch.randint(-127, 128, (n_slots, hkv1, s7, d1), generator=g, device="cuda",
                             dtype=torch.int8)

    kvs = [(codes(), codes(), randn(n_slots, hkv1, s7, 1).abs() * 0.01 + 1e-3,
            randn(n_slots, hkv1, s7, 1).abs() * 0.01 + 1e-3) for _ in range(L1)]
    k7 = {step: k7_case(torch, F, randn, kvs, t7, starts_, hq1, scale1)
          for step, t7, starts_ in (("decode", 1, [255, 0, 300, MAX_LEN]),
                                    ("mixed", 128, [0, 256, 300, MAX_LEN]))}
    del kvs
    lines.append(dict(
        name="flash_attention_blockwise_g12", route="cuda",
        source="zllm_torch/csrc/attn_blockwise.cu", replaces="zllm/ops/attention.py:165",
        launches=sum(by_path("flash_attention_blockwise").values()),
        **{k: k7["decode"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "nmse", "max_abs_err", "tolerance", "shapes")},
        library="scaled_dot_product_attention on K/V dequantized to bf16 outside the timing",
        launches_by_path=by_path("flash_attention_blockwise"),
        unit=f"one StarCoder2-3B ({L1} layers) q8 decode step ({L1} launches), int8 K/V",
        mixed_step=k7["mixed"]))
    for ln in lines:
        emit({"phase": "kernel_layernorm", "card": card, **ln})
    bad = [ln["name"] for ln in lines if not ln["nmse"] <= ln["tolerance"]]
    if not k7["mixed"]["nmse"] <= k7["mixed"]["tolerance"]:
        bad.append("flash_attention_blockwise_g12 mixed step")
    if bad:
        fail(f"this slice's forms disagree with their plain versions: {bad}")
    return lines


def ln_matmul_lines(torch, model, card: str, counts: dict) -> list[dict]:
    """The Pythia-1.4B Q4_K_M path's matmul kernels at its own shapes
    (random rows, seed 27): one decode step's 97 matvecs (wqkv, wo, up and
    down a layer, the head; all fuse "q": a LayerNorm model fuses no
    prologue) through K1 (Q4_K) and K4 (Q6_K: the first 12 ffn_down and
    the head), and one 256-row chunk's GEMMs through K3 and K5, each beside
    its bound (`matvec_phase`, `gemm_phase`: the head's real 50304
    columns), its plain version on one call of each shape and
    `torch.matmul` on the bf16-dequantized weights."""
    from zllm_torch.gguf.constants import GGMLType
    from zllm_torch.ops import qmatmul as qmm

    cfg, layers, head = model.cfg, model.params["layers"], model.params["output"]
    g = torch.Generator(device="cuda")
    g.manual_seed(27)

    def randn(*shape_, scale=1.0):
        return torch.randn(*shape_, generator=g, device="cuda") * scale

    def n_real(w):
        return cfg.vocab_size if w is head else w.shape[1]

    def first_of_each(calls, key):  # one call of each shape, for the plain check
        seen = {}
        for i, c in enumerate(calls):
            seen.setdefault(key(c), i)
        return tuple(seen.values())

    d, ff = cfg.n_embd, cfg.n_ff
    row = {k: randn(1, k, scale=3.0) for k in (d, cfg.q_dim, ff)}
    rows = {k: randn(CHUNK, k) for k in (d, cfg.q_dim, ff)}
    mv = {GGMLType.Q4_K: [], GGMLType.Q6_K: []}
    gm = {GGMLType.Q4_K: [], GGMLType.Q6_K: []}
    for layer in layers:
        for k, w in ((d, layer["wqkv"]), (cfg.q_dim, layer["wo"]), (d, layer["ffn_up"]),
                     (ff, layer["ffn_down"])):
            mv[w.fmt].append((row[k], w, "q", None))
            gm[w.fmt].append((rows[k], w))
    mv[head.fmt].append((row[d], head, "q", None))
    gm[head.fmt].append((rows[d], head))
    label = main_shapes()[LN_MAIN][1] + " Q4_K_M"
    lines = []
    # kernel: its source and the TPU kernel it replaces
    where = {"q4k_matvec": ("q4k_matvec.cu", "zllm/ops/qmatmul.py:683"),
             "int8_matvec": ("int8_matvec.cu", "zllm/ops/qmatmul.py:501"),
             "q4k_gemm": ("q4k_gemm.cu", "zllm/ops/qmatmul.py:1402"),
             "dequant_gemm": ("dequant_gemm.cu", "zllm/ops/qmatmul.py:1542")}
    for fmt, mv_name, fn, plain, gm_name, gfn, gplain in (
            (GGMLType.Q4_K, "q4k_matvec", qmm.q4k_matvec, qmm.q4k_matvec_plain, "q4k_gemm",
             qmm.q4k_gemm, qmm.q4k_gemm_plain),
            (GGMLType.Q6_K, "int8_matvec", qmm.int8_matvec, qmm.int8_matvec_plain,
             "dequant_gemm", qmm.dequant_gemm, qmm.dequant_gemm_plain)):
        bpw = GGUF_BYTES_PER_WEIGHT[fmt.name]
        step = matvec_phase(torch, fn, plain, mv[fmt], n_real, bpw, cfg.norm_eps,
                            check=first_of_each(mv[fmt], lambda c: c[1].shape))
        chunk = gemm_phase(torch, gfn, gplain, gm[fmt], n_real, bpw,
                           check=first_of_each(gm[fmt], lambda c: c[1].shape))
        for name, res, n, unit in (
                (mv_name, step, len(mv[fmt]), "one decode step"),
                (gm_name, chunk, len(gm[fmt]), f"one {CHUNK}-row prefill chunk")):
            lines.append(dict(
                name=f"{name}_pythia", route="cuda",
                source=f"zllm_torch/csrc/{where[name][0]}", replaces=where[name][1],
                launches=counts[name],
                **{k: res[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "nmse", "max_abs_err")},
                tolerance=1e-6, library="torch.matmul on the bf16-dequantized weights",
                unit=f"{unit} of {label}: {n} {fmt.name} launches",
                shapes=f"K x N {sorted({tuple(w.shape) for _, w, *_ in mv[fmt]})}"))
    for ln in lines:
        emit({"phase": "kernel_layernorm", "card": card, **ln})
    bad = [ln["name"] for ln in lines if not ln["nmse"] <= ln["tolerance"]]
    if bad:
        fail(f"the Pythia path's matmul kernels disagree with their plain versions: {bad}")
    return lines


def layernorm_group(torch, kernels: dict, card: str) -> dict:
    """Group 11: Pythia-1.4B's generate at full depth, StarCoder2-3B (8
    layers) behind the paged server, the 2-layer Pythia, StableLM-2 and
    StarCoder2 checks against the CPU, a 2-layer StarCoder2 q8 engine
    against the CPU's, and this slice's kernel lines (the attention forms
    it first runs; the Pythia path's matmuls at their shapes).
    Returns the paths' launch counts and the kernel lines."""
    import torch.nn.functional as F

    from zllm_torch.models.loader import Model

    t0 = time.perf_counter()

    def load(name):
        path, _ = gguf_file(name, main_shapes()[name][0], "Q4_K_M")
        return Model.load(str(path), device="cuda", dtype=torch.bfloat16)

    m_p = load(LN_MAIN)
    counts = {}
    _, counts[LN_MAIN], gen_p, _, tokens, _ = main_path(
        torch, "Q4_K_M", kernels, unfused_want(kernels, m_p), card, name=LN_MAIN, model=m_p,
        prompt_tokens=LN_PROMPT)
    pos_p = LN_PROMPT + len(tokens) - 1  # the last decode step's position
    m_s = load(LN_SERVE)
    counts[f"serve_{LN_SERVE}"] = serve_phase(
        torch, m_s, kernels, card, label=main_shapes()[LN_SERVE][1] + " Q4_K_M",
        gemms=gemm_counts(m_s), tag=LN_SERVE)
    for name in LN_CHECKS:
        counts[name] = ln_2layer_check(torch, kernels, card, name)
    for layout in LN_ENGINE_LAYOUTS:
        counts[f"{layout}_engine"] = small_engine_check(torch, kernels, layout)
    lines = ln_kernel_lines(torch, F, m_p, gen_p, pos_p, m_s, card, counts)
    lines += ln_matmul_lines(torch, m_p, card, counts[LN_MAIN])
    del m_p, gen_p, m_s
    torch.cuda.empty_cache()
    emit({"phase": "layernorm_group", "seconds": time.perf_counter() - t0, "card": card})
    return {"counts": counts, "lines": lines}


def layernorm_phases():
    """`python3 chip_smoke.py --layernorm`: group 11 alone after building
    the kernels (its files and CPU references made by children
    meanwhile)."""
    torch, card = setup_card()
    from zllm_torch.ops import cuda

    t0 = time.perf_counter()
    reports = cuda.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "built": sorted(reports)})
    start_ln_children()
    kernels = kernel_wrappers()
    layernorm_group(torch, kernels, card)
    emit({"phase": "form_digests", "tree": str(REPO),
          "layernorm": layernorm_form_digests(torch)})
    print(card, flush=True)


def layernorm_form_digests(torch) -> dict:
    """Digests of the forms this slice first runs, on a stream of their own
    (seed 270), so that the earlier digests keep theirs: K2 with neox rope
    over 32 of 128 and 16 of 64 dims and at G 12, d 128 (the output and
    both caches after the insert), K9 at G 12 (output and pools), K10 and
    K6 at G 12, each over f32, bf16 and f16 K/V (K9/K10: bf16 and f16
    pools, K10's f32 pool the tile loop too)."""
    from zllm_torch.ops import attention as att
    from zllm_torch.ops.layers import RopeParams, rope_table

    g = torch.Generator(device="cuda")
    g.manual_seed(270)

    def randn(*shape_, dtype=torch.float32):
        return torch.randn(*shape_, generator=g, device="cuda").to(dtype)

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            torch.cuda.synchronize()
            h.update(t.float().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    kv_dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    out = {}
    for form, (hq, hkv, d, r) in {"k2_neox_r32_d128": (16, 16, 128, 32),
                                  "k2_neox_r16_d64": (32, 32, 64, 16),
                                  "k2_g12_d128": (24, 2, 128, 128)}.items():
        for cn, cd in kv_dtypes.items():
            pos = torch.tensor([331, 0, 511], dtype=torch.int32, device="cuda")
            qkv3 = randn(3, hq + 2 * hkv, d)
            kc, vc = (randn(3, hkv, 512, d, dtype=cd) for _ in range(2))
            rt = rope_table(pos, RopeParams(dim=r, style="neox"), d)
            y = att.attn_decode_qkv(qkv3, kc, vc, pos, rt, scale=d ** -0.5)
            out[f"{form}_{cn}"] = digest(y, kc, vc)
    hq, hkv, d, ps, lp, n = 24, 2, 128, 128, 8, 3
    table = _paged_table(torch, n, lp, 270)
    for pn in ("bf16", "f16"):
        pools = [randn(hkv, (n * lp + 1) * ps, d, dtype=kv_dtypes[pn]) for _ in range(2)]
        pos9 = torch.tensor([[127], [0], [700]], dtype=torch.int32, device="cuda")
        q9, kn, vn = (randn(n, 1, h, d) for h in (hq, hkv, hkv))
        y = att.paged_attn_decode_update(q9, kn, vn, *pools, table, pos9, page_size=ps,
                                         scale=d ** -0.5)
        out[f"k9_g12_d128_{pn}"] = digest(y, *pools)
    for pn, pd in kv_dtypes.items():
        pools = [randn(hkv, (n * lp + 1) * ps, d, dtype=pd) for _ in range(2)]
        starts = torch.tensor([0, 300, 900], dtype=torch.int32, device="cuda")
        pos10 = starts[:, None] + torch.arange(64, dtype=torch.int32, device="cuda")[None]
        y = att.paged_attention(randn(n, 64, hq, d), *pools, table, pos10, page_size=ps,
                                scale=d ** -0.5)
        out[f"k10_g12_d128_{pn}"] = digest(y)
        k, v = (randn(1, hkv, 1024, d, dtype=pd) for _ in range(2))
        pos6 = (256 + torch.arange(256, dtype=torch.int32, device="cuda"))[None]
        y = att.flash_attention(randn(1, 256, hq, d), k, v, pos6, scale=d ** -0.5)
        out[f"k6_g12_d128_{pn}"] = digest(y)
    return out

# ---- group 12: gpt-oss (attention sinks, swiglu_oai experts with biases) --------

def start_oss_children():
    """Group 12's file (gpt-oss-20b at OSS_LAYERS layers, as llama.cpp ships
    it) and the 2-layer check's CPU side (which makes its file), niced."""
    import atexit

    prepare_requantized([(OSS_MAIN, (OSS_FTYPE,))])
    _CPU_CHECKS[OSS_CHECK] = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--moe-cpu", OSS_CHECK], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: [c.kill() for c in _CPU_CHECKS.values() if c.poll() is None])


def oss_chat_ring(torch, model, kernels: dict, card: str) -> dict:
    """gpt-oss behind ZllmServer (OSS_SLOTS slots, the auto layout: the ring
    cache, its windowed layers' rings of 256 slots): OSS_CHAT_TOKENS-id chat
    prompts (the harmony template; all but the last past the ring) sent
    together to /v1/chat/completions, then one at a time; the texts must
    agree, the launches be K2 and K6 in the full layers alone, each in its
    sinks form, as the engine's step counters imply, and no matmul kernel
    (every weight takes the dequantizing route).  Returns the counts."""
    from zllm_torch.ops import attention as att
    from zllm_torch.runtime.kvcache import KVCacheSWA
    from zllm_torch.server.http import ZllmServer

    tok = model.tokenizer
    base = tok.encode("The quick brown fox jumps over the lazy dog while the chip counts every "
                      "byte it reads. " * 200)
    bodies = [{"messages": [{"role": "user", "content": f"Request {i}: "
                             + tok.decode(base[7 * i:7 * i + n])}],
               "max_tokens": OSS_CHAT_NEW, "temperature": 0}
              for i, n in enumerate(OSS_CHAT_TOKENS)]
    srv = ZllmServer(model, port=0, n_slots=OSS_SLOTS)
    srv.start_background()
    eng = srv.engine
    sinks_fns = (att.attn_decode_qkv, att.flash_attention)
    try:
        if not isinstance(eng.kv, KVCacheSWA) or eng.paged:
            fail("gpt-oss's server did not take the ring cache")
        http_post(srv.port, "/v1/chat/completions", dict(bodies[-1], max_tokens=4))  # warm-up
        for fn in kernels.values():
            fn.launches = 0
        for fn in sinks_fns:
            fn.sinks_launches = 0
        m0 = dict(eng.metrics)
        together = {}

        def client(i):
            together[i] = json.loads(http_post(srv.port, "/v1/chat/completions", bodies[i]))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        window = time.perf_counter() - t0
        if any(t.is_alive() for t in threads) or len(together) != len(bodies):
            fail("serve_ring_gpt_oss: concurrent chat requests did not finish")
        alone = {i: json.loads(http_post(srv.port, "/v1/chat/completions", b))
                 for i, b in enumerate(bodies)}
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in kernels.items()}
        sinks = {fn.__name__: fn.sinks_launches for fn in sinks_fns}
        m1 = dict(eng.metrics)
        ring, swa = eng.kv.ring, eng.kv.swa_mask
    finally:
        srv.shutdown()
    steps = {k: m1[k] - m0[k] for k in ENGINE_COUNTERS}
    n_full = sum(not w for w in swa)
    expected = serve_expected(kernels, model.cfg, steps, contig=True, gemms={},
                              att_layers=n_full)
    texts = [together[i]["choices"][0]["message"]["content"] for i in range(len(bodies))]
    same = texts == [alone[i]["choices"][0]["message"]["content"] for i in range(len(bodies))]
    prompt_ids_n = [together[i]["usage"]["prompt_tokens"] for i in range(len(bodies))]
    gen_tokens = sum(r["usage"]["completion_tokens"] for r in together.values())
    finishes = [r["choices"][0]["finish_reason"] for r in (*together.values(), *alone.values())]
    res = {"phase": "serve_ring_chat_gpt_oss",
           "model": main_shapes()[OSS_MAIN][1] + f" {OSS_FTYPE} (random weights, seed 0)",
           "route": "/v1/chat/completions (harmony template)", "n_slots": eng.n_slots,
           "max_len": eng.max_len, "chunk": eng.prefill_chunk,
           "kv_layout": "ring (KVCacheSWA)", "ring_slots": ring, "ring_layers": sum(swa),
           "full_layers": n_full, "prompt_tokens": prompt_ids_n,
           "prompts_past_the_ring": sum(n > ring for n in prompt_ids_n),
           "max_tokens": OSS_CHAT_NEW, "concurrent_window_s": window,
           "generated_tokens": gen_tokens, "generated_tok_s": gen_tokens / window,
           "concurrent_equals_sequential": same, "finish_reasons": finishes,
           "engine_counters": steps, "launches": counts, "launches_expected": expected,
           "sinks_launches": sinks, "card": card}
    emit(res)
    if steps["engine_errors_total"] or "error" in finishes or "" in finishes:
        fail(f"serve_ring_gpt_oss: engine errors {steps['engine_errors_total']}, "
             f"finishes {finishes}")
    if not same:
        fail(f"serve_ring_gpt_oss: concurrent chat texts differ from sequential ones: {texts}")
    if sum(n > ring for n in prompt_ids_n) < len(bodies) - 1:
        fail(f"serve_ring_gpt_oss: prompts of {prompt_ids_n} ids do not wrap the {ring}-slot ring")
    if counts != expected or not steps["decode_steps_total"] or not steps["prefill_steps_total"]:
        fail(f"serve_ring_gpt_oss: kernel launch counts {counts} != expected {expected}")
    if sinks != {"attn_decode_qkv": counts["attn_decode_qkv"],
                 "flash_attention": counts["flash_attention"]}:
        fail(f"serve_ring_gpt_oss: sinks-form launches {sinks} != the launches {counts}")
    return counts


def oss_q8_path(torch, model, ids: list, kernels: dict, card: str) -> dict:
    """The q8 cache's route for gpt-oss (`forward` over KVCacheQ8: the engine
    refuses a q8 cache on a windowed model, the Generator takes a dtype):
    the prompt in chunks, then 8 greedy decode steps, over the q8 cache and
    over a bf16 stripe fed the same tokens; every K7 launch in its sinks
    form (a chunk: the multi-row form and column 0 once more; a step: the
    split form), no other attention kernel; the q8 logits' nmse against the
    bf16 stripe's reported."""
    from zllm_torch.models.llama import forward
    from zllm_torch.ops import attention as att
    from zllm_torch.runtime.kvcache import KVCache, KVCacheQ8

    cfg = model.cfg
    n_steps = 8
    caches = {"bf16": KVCache.create(cfg.n_layers, 1, MAX_LEN, cfg.n_kv_heads, cfg.head_dim,
                                     torch.bfloat16, "cuda"),
              "q8": KVCacheQ8.create(cfg.n_layers, 1, MAX_LEN, cfg.n_kv_heads, cfg.head_dim,
                                     device="cuda")}

    def run(kv, toks, start):
        tt = torch.tensor([toks], dtype=torch.int32, device="cuda")
        pp = torch.arange(start, start + len(toks), dtype=torch.int32, device="cuda")[None]
        with torch.inference_mode():
            return forward(model.params, cfg, tt, pp, kv, logits_for="last")[0, -1].float()

    out = {}
    for name, kv in caches.items():
        if name == "q8":
            for fn in kernels.values():
                fn.launches = 0
            att.flash_attention_blockwise.sinks_launches = 0
        logits = [run(kv, ids[c:c + CHUNK], c) for c in range(0, len(ids), CHUNK)][-1:]
        fed = out["bf16"]["fed"] if name == "q8" else []
        for i in range(n_steps):
            if name == "bf16":
                fed.append(int(torch.argmax(logits[-1])))
            logits.append(run(kv, [fed[i]], len(ids) + i))
        torch.cuda.synchronize()
        out[name] = dict(fed=fed, logits=torch.stack(logits))
        if name == "q8":
            counts = {n: fn.launches for n, fn in kernels.items()}
            sinks7 = att.flash_attention_blockwise.sinks_launches
    n_chunks = -(-len(ids) // CHUNK)
    expected = dict({n: 0 for n in kernels},
                    flash_attention_blockwise=cfg.n_layers * (2 * n_chunks + n_steps))
    errs = [nmse(a, b) for a, b in zip(out["q8"]["logits"], out["bf16"]["logits"])]
    agree = sum(int(torch.argmax(a)) == int(torch.argmax(b))
                for a, b in zip(out["q8"]["logits"], out["bf16"]["logits"]))
    res = {"phase": "q8_path_gpt_oss", "model": main_shapes()[OSS_MAIN][1],
           "prompt_tokens": len(ids), "decode_steps": n_steps, "launches": counts,
           "launches_expected": expected, "sinks_launches": sinks7,
           "logits_nmse_vs_bf16_stripe_by_step": errs, "argmax_agree": f"{agree}/{len(errs)}",
           "finite": bool(torch.isfinite(out["q8"]["logits"]).all()), "card": card}
    emit(res)
    if counts != expected or sinks7 != counts["flash_attention_blockwise"]:
        fail(f"q8_path_gpt_oss: launches {counts} (sinks {sinks7}) != expected {expected}")
    if not res["finite"]:
        fail("q8_path_gpt_oss: the q8 cache's logits are not finite")
    return counts


def oss_kernel_lines(torch, F, model, gen, pos_v: int, card: str, paths: dict) -> list[dict]:
    """The sinks forms at gpt-oss's shapes (64 / 8 heads of 64, G 8, its
    yarn rope, windows 128 and 0 on alternate layers, the model's sink
    logits), each against its plain version, one SDPA call a layer without
    the sink (SDPA takes none) and its bound: K2 over the main path's decode
    step (its caches at the last position), K6 over a 256-token chunk from
    256 on those caches, and K7 over int8 K/V at a 4-slot engine's steps (a
    decode step: the split form; a mixed step of 128 rows) (`k7_case`)."""
    from zllm_torch.ops import attention as att
    from zllm_torch.ops.layers import rope_table

    cfg = model.cfg
    L, hq, hkv, d = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = cfg.attn_scale or d ** -0.5
    sinks = [layer["attn_sinks"] for layer in model.params["layers"]]
    windows = [cfg.layer_window(il) for il in range(L)]
    g = torch.Generator(device="cuda")
    g.manual_seed(28)

    def randn(*shape_, dtype=torch.float32):
        return torch.randn(*shape_, generator=g, device="cuda").to(dtype)

    def by_path(name):
        return {p: c.get(name, 0) for p, c in paths.items()}

    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    lines = [_k2_line(torch, F, att, name="attn_decode_qkv_sinks", cfg=cfg, kcs=gen.kv.k,
                      vcs=gen.kv.v, pos_v=pos_v, randn=randn, by_path=by_path,
                      ropes=[rope_table(pos, cfg.layer_rope(il), d) for il in range(L)],
                      windows=windows, sinks=sinks,
                      unit=f"one {main_shapes()[OSS_MAIN][1]} decode step")]

    # K6 with sinks: a chunk of 256 from 256 over the main path's caches
    kcs, vcs = gen.kv.k, gen.kv.v
    t6, p6 = CHUNK, CHUNK
    pos6 = (p6 + torch.arange(t6, dtype=torch.int32, device="cuda"))[None]
    q6 = randn(1, t6, hq, d)
    errs = []
    for il in (0, 1):  # a windowed layer and a full one
        a = att.flash_attention(q6, kcs[il], vcs[il], pos6, scale=scale, window=windows[il],
                                sinks=sinks[il])
        b = att.flash_attention_plain(q6, kcs[il], vcs[il], pos6, scale=scale,
                                      window=windows[il], sinks=sinks[il])
        errs.append((nmse(a.float(), b.float()), float((a.float() - b.float()).abs().max())))

    def k6(fn):
        def go():
            for il in range(L):
                fn(q6, kcs[il], vcs[il], pos6, scale=scale, window=windows[il], sinks=sinks[il])
        return go

    q6b = q6.to(torch.bfloat16).transpose(1, 2)
    cols = torch.arange(kcs[0].shape[2], device="cuda")[None]
    qp = pos6[0][:, None]
    masks = {w: ((cols <= qp) & ((cols > qp - w) if w else True)).reshape(1, 1, t6, -1)
             for w in set(windows)}

    def k6_lib():
        for il in range(L):
            F.scaled_dot_product_attention(q6b, kcs[il], vcs[il], attn_mask=masks[windows[il]],
                                           scale=scale, enable_gqa=True)

    pairs = sum(p6 + i + 1 - (max(p6 + i - w + 1, 0) if w else 0)
                for w in windows for i in range(t6))
    seen = sum(p6 + t6 - (max(p6 - w + 1, 0) if w else 0) for w in windows)
    b6 = bound_ms(L * 2 * q6.numel() * 4 + 2 * hkv * seen * d * 2, 4 * hq * d * pairs, "bf16")
    lines.append(dict(
        name="flash_attention_sinks", route="cuda", source="zllm_torch/csrc/flash_attn.cu",
        replaces="zllm/ops/attention.py:33", launches=sum(by_path("flash_attention").values()),
        max_abs_err=max(m for _, m in errs), nmse=max(e for e, _ in errs), tolerance=1e-5,
        ms=cuda_ms(k6(att.flash_attention), 10), plain_ms=cuda_ms(k6(att.flash_attention_plain), 2),
        bound_ms=b6[0], bound_by=b6[1], library_ms=cuda_ms(k6_lib, 10),
        library="scaled_dot_product_attention (causal and window masks; no sink: SDPA takes "
                "none)",
        launches_by_path=by_path("flash_attention"),
        unit=f"one {main_shapes()[OSS_MAIN][1]} prefill chunk ({L} launches)",
        shapes=f"q [1,{t6},{hq},{d}] f32 from {p6}, k/v [1,{hkv},{kcs[0].shape[2]},{d}] bf16, "
               f"G {hq // hkv}, windows {windows}, sinks [{hq}] f32"))

    # K7 with sinks over int8 K/V at a 4-slot engine's steps (S 2176)
    n_slots, s7 = 4, MAX_LEN + 128

    def codes():
        return torch.randint(-127, 128, (n_slots, hkv, s7, d), generator=g, device="cuda",
                             dtype=torch.int8)

    kvs = [(codes(), codes(), randn(n_slots, hkv, s7, 1).abs() * 0.01 + 1e-3,
            randn(n_slots, hkv, s7, 1).abs() * 0.01 + 1e-3) for _ in range(L)]
    k7 = {step: k7_case(torch, F, randn, kvs, t7, starts_, hq, scale, sinks=sinks,
                        windows=windows)
          for step, t7, starts_ in (("decode", 1, [255, 0, 300, MAX_LEN]),
                                    ("mixed", 128, [0, 256, 300, MAX_LEN]))}
    del kvs
    lines.append(dict(
        name="flash_attention_blockwise_sinks", route="cuda",
        source="zllm_torch/csrc/attn_blockwise.cu", replaces="zllm/ops/attention.py:165",
        launches=sum(by_path("flash_attention_blockwise").values()),
        **{k: k7["decode"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "nmse", "max_abs_err", "tolerance", "shapes")},
        library="scaled_dot_product_attention on K/V dequantized to bf16 outside the timing "
                "(no sink: SDPA takes none)",
        launches_by_path=by_path("flash_attention_blockwise"),
        unit=f"a 4-slot q8 decode step at gpt-oss's shapes ({L} launches), int8 K/V, windows "
             f"{windows}", mixed_step=k7["mixed"]))
    for ln in lines:
        emit({"phase": "kernel_gpt_oss", "card": card, **ln})
    bad = [ln["name"] for ln in lines if not ln["nmse"] <= ln["tolerance"]]
    if not k7["mixed"]["nmse"] <= k7["mixed"]["tolerance"]:
        bad.append("flash_attention_blockwise_sinks mixed step")
    if bad:
        fail(f"the sinks forms disagree with their plain versions: {bad}")
    return lines


def gpt_oss_group(torch, kernels: dict, card: str) -> dict:
    """Group 12: gpt-oss-20b (OSS_LAYERS layers) through the Generator (the
    prompt past its window in chunks, 31 decode steps, K2 and K6 in their
    sinks forms and no matmul kernel, from the recorded routing), its q8
    route (K7 with sinks), the ring server under concurrent chat requests,
    the 2-layer full-width check against the CPU, and the sinks forms'
    kernel lines.  Returns the paths' launch counts and the kernel lines."""
    import torch.nn.functional as F

    t0 = time.perf_counter()
    model, counts_main, gen, ids, tokens, _ = moe_main_path(torch, kernels, card, name=OSS_MAIN,
                                                            ftype=OSS_FTYPE)
    pos_v = PROMPT_TOKENS + len(tokens) - 1  # the last decode step's position
    counts = {OSS_MAIN: counts_main,
              "q8_path_gpt_oss": oss_q8_path(torch, model, ids, kernels, card),
              "serve_ring_chat_gpt_oss": oss_chat_ring(torch, model, kernels, card)}
    lines = oss_kernel_lines(torch, F, model, gen, pos_v, card, counts)
    del model, gen
    torch.cuda.empty_cache()
    counts[OSS_CHECK] = moe_2layer_check(torch, kernels, card, OSS_CHECK, phase="gpt_oss_2layer",
                                         must=("attn_decode_qkv", "flash_attention"),
                                         tie_gap=LN_TIE_GAP)
    torch.cuda.empty_cache()
    emit({"phase": "gpt_oss_group", "seconds": time.perf_counter() - t0, "card": card})
    return {"counts": counts, "lines": lines}


def gpt_oss_phases():
    """`python3 chip_smoke.py --gpt-oss`: group 12 alone after building the
    kernels (its file and CPU reference made by children meanwhile), then
    the sinks forms' digests."""
    torch, card = setup_card()
    from zllm_torch.ops import cuda

    t0 = time.perf_counter()
    start_oss_children()
    reports = cuda.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "built": sorted(reports),
          "attn_decode": ptxas_entries({"attn_decode": reports.get("attn_decode", "")},
                                       "attn_decode_qkv_kernel")})
    kernels = kernel_wrappers()
    gpt_oss_group(torch, kernels, card)
    emit({"phase": "form_digests", "tree": str(REPO), "gpt_oss": gpt_oss_form_digests(torch)})
    print(card, flush=True)


def gpt_oss_form_digests(torch) -> dict:
    """Digests of the sinks forms this slice first runs, on a stream of
    their own (seed 280): K2 with sinks at G 8, d 64 (windows 0 and 128;
    the output and both caches after the insert) over f32, bf16 and f16
    caches, K6 with sinks over f32, bf16 and f16 K/V, and K7 with sinks over
    int8 and bf16 K/V (a decode row set and a 64-row chunk)."""
    from zllm_torch.ops import attention as att
    from zllm_torch.ops.layers import RopeParams, rope_table

    g = torch.Generator(device="cuda")
    g.manual_seed(280)

    def randn(*shape_, dtype=torch.float32):
        return torch.randn(*shape_, generator=g, device="cuda").to(dtype)

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            torch.cuda.synchronize()
            h.update(t.float().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    hq, hkv, d = 16, 2, 64
    kv_dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    sinks = randn(hq) * 2
    out = {}
    rope = RopeParams(dim=d, base=150000.0, style="neox", scaling="yarn", scale_factor=32.0,
                      orig_ctx=4096)
    for w in (0, 128):
        for cn, cd in kv_dtypes.items():
            pos = torch.tensor([331, 0, 1100], dtype=torch.int32, device="cuda")
            qkv3 = randn(3, hq + 2 * hkv, d)
            kc, vc = (randn(3, hkv, 1152, d, dtype=cd) for _ in range(2))
            y = att.attn_decode_qkv(qkv3, kc, vc, pos, rope_table(pos, rope, d),
                                    scale=d ** -0.5, window=w, sinks=sinks)
            out[f"k2_sinks_w{w}_{cn}"] = digest(y, kc, vc)
            k, v = (randn(1, hkv, 1024, d, dtype=cd) for _ in range(2))
            pos6 = (256 + torch.arange(256, dtype=torch.int32, device="cuda"))[None]
            y = att.flash_attention(randn(1, 256, hq, d), k, v, pos6, scale=d ** -0.5, window=w,
                                    sinks=sinks)
            out[f"k6_sinks_w{w}_{cn}"] = digest(y)
        for kn in ("int8", "bf16"):
            if kn == "int8":
                k, v = (torch.randint(-127, 128, (3, hkv, 1152, d), generator=g, device="cuda",
                                      dtype=torch.int8) for _ in range(2))
                ks, vs = (randn(3, hkv, 1152, 1).abs() * 0.01 + 1e-3 for _ in range(2))
            else:
                (k, v), ks, vs = (randn(3, hkv, 1152, d, dtype=torch.bfloat16)
                                  for _ in range(2)), None, None
            for t in (1, 64):
                starts = torch.tensor([0, 300, 1024], dtype=torch.int32, device="cuda")
                pos7 = starts[:, None] + torch.arange(t, dtype=torch.int32, device="cuda")[None]
                y = att.flash_attention_blockwise(randn(3, t, hq, d), k, v, pos7,
                                                  scale=d ** -0.5, window=w, sinks=sinks, ks=ks,
                                                  vs=vs)
                out[f"k7_sinks_w{w}_{kn}_t{t}"] = digest(y)
    return out


def kernel_wrappers() -> dict:
    """The twelve kernels' wrappers, by name; each counts its launches."""
    from zllm_torch.ops import attention as att
    from zllm_torch.ops import qmatmul as qmm

    return {"q4k_matvec": qmm.q4k_matvec, "int8_matvec": qmm.int8_matvec,
            "attn_decode_qkv": att.attn_decode_qkv, "q4k_gemm": qmm.q4k_gemm,
            "dequant_gemm": qmm.dequant_gemm, "flash_attention": att.flash_attention,
            "paged_attn_decode_update": att.paged_attn_decode_update,
            "paged_attention": att.paged_attention,
            "flash_attention_blockwise": att.flash_attention_blockwise,
            "attn_decode_update": att.attn_decode_update,
            "q4k_matvec_hbm": qmm.q4k_matvec_hbm, "w4a8dd_matvec": qmm.w4a8dd_matvec}


def setup_card():
    """Import torch from beside the checkout and read the card; fails with
    no checkout beside the script or no CUDA card.  Returns (torch, card)."""
    if not (REPO / "zllm_torch" / "csrc").is_dir():
        fail("zllm_torch/ is not beside chip_smoke.py: run from the root of a checkout")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CACHE.mkdir(parents=True, exist_ok=True)
    return torch, smi.stdout.strip().splitlines()[0]


def api_phases():
    """`python3 chip_smoke.py --api`: group 7 alone (slot state, the API
    surface, the router, the prompt cache, the switches) after building
    the kernels, on the TinyLlama Q4_K_M model."""
    torch, card = setup_card()
    from zllm_torch.models.loader import Model
    from zllm_torch.ops import cuda

    t0 = time.perf_counter()
    reports = cuda.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "built": sorted(reports)})
    kernels = kernel_wrappers()
    path, made_s = gguf_file("tinyllama", main_shapes()["tinyllama"][0], "Q4_K_M")
    model_m = Model.load(str(path), device="cuda", dtype=torch.bfloat16)
    emit({"phase": "api_model", "file": path.name, "made_s": made_s})
    for ph in SLOT_CASES:
        slots_phase(torch, model_m, kernels, card, ph)
    messages_infill_tools_phase(torch, model_m, kernels, card)
    router_phase(torch, kernels, card)
    prompt_cache_phase(card)
    switches_phase(torch, model_m, kernels, card)
    print(card, flush=True)


def serve_q8_ab(n: int):
    """`python3 chip_smoke.py --serve-q8 N`: the serve_q8 phase N times on
    the TinyLlama Q4_K_M model, then the q8 cache's insert alone: one
    decode step's 22 `KVCacheQ8.update` calls (B 4, T 1), host wall ms a
    step with a synchronize, median of 300, for the quantize as it stands
    and, alternated in the same process, with 127 as a 0-dim tensor made
    every call and as a Python scalar (the two earlier forms).  A copy of
    this script beside another tree's zllm_torch times that tree."""
    import numpy as np

    torch, card = setup_card()
    from zllm_torch.models.loader import Model
    from zllm_torch.ops import cuda
    from zllm_torch.runtime import kvcache

    cuda.build()
    kernels = kernel_wrappers()
    path, _ = gguf_file("tinyllama", main_shapes()["tinyllama"][0], "Q4_K_M")
    model = Model.load(str(path), device="cuda", dtype=torch.bfloat16)
    for _ in range(n):
        serve_phase(torch, model, kernels, card, kv_dtype="q8")

    cfg = model.cfg
    kv = kvcache.KVCacheQ8.create(cfg.n_layers, 4, 2176, cfg.n_kv_heads, cfg.head_dim)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 1, cfg.n_kv_heads, cfg.head_dim, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    pos = torch.tensor([[100], [200], [300], [400]], dtype=torch.int32, device="cuda")

    def quant_scalar(x):
        xf = x.float()
        s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
        return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s

    def quant_per_call(x):
        xf = x.float()
        s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True)
                            / torch.full((), 127.0, device=x.device), 1e-12)
        return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s

    forms = {"as_is": kvcache.KVCacheQ8._quant, "per_call_0dim": quant_per_call,
             "python_scalar": quant_scalar}
    times = {name: [] for name in forms}
    for rep in range(320):
        for name, fn in forms.items():
            with mock.patch.object(kvcache.KVCacheQ8, "_quant", staticmethod(fn)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for il in range(cfg.n_layers):
                    kv.update(il, x, x, pos)
                torch.cuda.synchronize()
                if rep >= 20:  # the first 20 warm up
                    times[name].append(1e3 * (time.perf_counter() - t0))
    emit({"phase": "q8_insert", "tree": str(REPO), "layers": cfg.n_layers,
          "shape": list(x.shape), "reps": len(times["as_is"]),
          "ms_median": {k: float(np.median(v)) for k, v in times.items()},
          "ms_mean": {k: float(np.mean(v)) for k, v in times.items()}, "card": card})
    print(card, flush=True)


def main():
    torch, card = setup_card()
    import torch.nn.functional as F

    prepare_requantized()

    from zllm_torch.gguf.constants import GGMLType
    from zllm_torch.ops import attention as att
    from zllm_torch.ops import cuda
    from zllm_torch.ops import qmatmul as qmm
    from zllm_torch.ops.layers import rope_apply_table, rope_table
    from zllm_torch.quant import blocks as qb
    from zllm_torch.quant.repack import repack

    t0 = time.perf_counter()
    reports = cuda.build()
    ptxas = [line.strip() for log in reports.values() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "built": sorted(reports), "ptxas": ptxas})
    prepare_requantized(PREQUANTIZE_LATE)
    start_gemma_children()  # group 9's files and CPU references, while the card works
    mma_build = ptxas_entries(reports, "attn_mma_kernel")
    k6_build = ptxas_entries({"flash_attn": reports.get("flash_attn", "")}, "flash_mma_kernel")
    emit({"phase": "build_attn_mma", "instantiations": mma_build + k6_build,
          "note": "registers and spills of the tensor-core attention loops: attn_mma.cuh (K7 "
                  "multi-row, K10 bf16 and f16) and K6's two-pass form (flash_attn.cu, bf16 and "
                  "f16 K/V; q f32/bf16 x D 64/128/256)" if mma_build else "not built in this run "
                  "(cached)"})
    spills = [e for e in mma_build + k6_build if e["spill_stores"] or e["spill_loads"]]
    if spills:
        fail(f"the tensor-core attention loop spills: {spills}")
    if "flash_attn" in reports and len(k6_build) != 12:
        fail(f"flash_attn: {len(k6_build)} tensor-core instantiations built, not 12")
    slice_build = ptxas_entries(reports, "zt_slice")
    emit({"phase": "build_gemm_slice", "instantiations": slice_build,
          "note": "registers and spills of the sliced GEMM loop (csrc/gemm_slice.cuh) of K3 "
                  "(q4k_gemm.cu: NibbleSlice for Q4_K, Q4_0, Q4_1, Q5_0, Q5_1, Q5_K) and K5 "
                  "(dequant_gemm.cu: "
                  "Q6KSlice, Q80Slice, CrumbSlice for Q2_K / Q3_K, TableSlice for IQ4_NL and "
                  "IQ4_XS / MXFP4 / IQ2_XXS / IQ2_XS and IQ2_S / IQ3_XXS / IQ3_S, IQ1CrumbSlice "
                  "for IQ1_S / IQ1_M and, without the min, TQ1_0 / TQ2_0), RowForm and TileForm per "
                  "decoder, and its round and "
                  "reduction kernels" if slice_build else "not built in this run (cached)"})
    spills = [e for e in slice_build if e["spill_stores"] or e["spill_loads"]]
    if spills:
        fail(f"the sliced GEMM loop spills: {spills}")
    cluster_build = ptxas_entries({lib: reports.get(lib, "") for lib in
                                   ("attn_blockwise", "paged_decode", "attn_decode_update")},
                                  "decode_cluster_kernel")
    emit({"phase": "build_decode_cluster", "instantiations": cluster_build,
          "note": "registers and spills of the one-launch cluster decode step "
                  "(csrc/decode_cluster.cuh): K7's split form (attn_blockwise.cu: q f32/bf16 x "
                  "K/V int8/bf16 x D 64/128/256), K9 (paged_decode.cu: q f32/bf16 x pools "
                  "f32/bf16/f16 x D 64/128, bf16/f16 at D 256) and K8 (attn_decode_update.cu: "
                  "q f32/bf16 x caches "
                  "f32/bf16/f16 x D 64/128)" if cluster_build else "not built in this run (cached)"})
    spills = [e for e in cluster_build if e["spill_stores"] or e["spill_loads"]]
    if spills:
        fail(f"the cluster decode step spills: {spills}")
    for lib, n_inst in (("attn_blockwise", 12), ("paged_decode", 16), ("attn_decode_update", 12)):
        inst = ptxas_entries({lib: reports.get(lib, "")}, "decode_cluster_kernel")
        if lib in reports and len(inst) != n_inst:
            fail(f"{lib}: {len(inst)} cluster decode instantiations built, not {n_inst}")
    # K8's clusters the card holds at once, each instantiation at its main
    # path's shape (D 128: the OLMo-2 step's 16 clusters; D 64: the
    # TinyLlama engine step's 16), beside the clusters a call launches
    k8_occupancy = {}
    for qn, qd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for cn, cd in (("f32", torch.float32), ("bf16", torch.bfloat16), ("f16", torch.float16)):
            for d, b_, hq_, hkv_, s_ in ((128, 1, 16, 16, MAX_LEN), (64, 4, 32, 4, MAX_LEN + 128)):
                k8_occupancy[f"q {qn} cache {cn} D {d}"] = dict(
                    max_active_clusters=att.attn_decode_update_clusters(qd, cd, b_, hq_, hkv_,
                                                                        d, s_),
                    clusters_a_call=b_ * hkv_ * -(-hq_ // hkv_ // 8))
    emit({"phase": "build_k8_clusters", "k8": k8_occupancy,
          "note": "cudaOccupancyMaxActiveClusters of K8's instantiations (attn_decode_update.cu "
                  "on decode_cluster.cuh, 8 blocks a cluster) at S 2048 (D 128) / 2176 (D 64)"})
    k1_build = ptxas_entries({"q4k_matvec": reports.get("q4k_matvec", "")}, "q4k_matvec_kernel")
    emit({"phase": "build_q4k_matvec", "instantiations": k1_build,
          "note": "registers and spills of K1 (csrc/q4k_matvec.cu: Q4_K/Q4_0/Q4_1/Q5_0/Q5_1/"
                  "Q5_K x prologue q/norm/glu x f32/bf16; 512 threads, at most 64 registers for "
                  "two blocks an SM)" if k1_build else "not built in this run (cached)"})
    spills = [e for e in k1_build if e["spill_stores"] or e["spill_loads"]]
    if spills:
        fail(f"K1 spills: {spills}")
    if "q4k_matvec" in reports and len(k1_build) != 36:
        fail(f"q4k_matvec: {len(k1_build)} K1 instantiations built, not 36")
    k4k2_build = {lib: ptxas_entries({lib: reports.get(lib, "")}, entry)
                  for lib, entry in (("int8_matvec", "int8_matvec_kernel"),
                                     ("attn_decode", "attn_decode_qkv_kernel"))}
    emit({"phase": "build_k4_k2", "instantiations": k4k2_build,
          "note": "registers and spills of K4 (csrc/int8_matvec.cu: Q6_K/Q8_0/Q2_K/Q3_K/"
                  "IQ4/MXFP4/IQ2 (32-groups)/IQ2 (16-groups)/IQ3_XXS/IQ3_S/IQ1_S/TQ x prologue "
                  "q/norm/glu x f32/bf16; IQ4_NL and IQ4_XS share one decoder, IQ2_XS and "
                  "IQ2_S another, TQ1_0 and TQ2_0 a third) and K2 (csrc/attn_decode.cu: q "
                  "f32/bf16 x cache "
                  "f32/bf16/f16 x D 64/128/256)" if any(k4k2_build.values())
                  else "not built in this run (cached)"})
    spills = [e for v in k4k2_build.values() for e in v if e["spill_stores"] or e["spill_loads"]]
    if spills:
        fail(f"K4 or K2 spills: {spills}")
    for lib, n_inst in (("int8_matvec", 72), ("attn_decode", 18)):
        if lib in reports and len(k4k2_build[lib]) != n_inst:
            fail(f"{lib}: {len(k4k2_build[lib])} instantiations built, not {n_inst}")
    # the f16 forms (an __half K/V type): K10's tensor-core loop (q f32/bf16 x D
    # 64/128 x chunks of 64/128, D 256 x chunks of 64), K6's two passes, K9's
    # cluster step and K2 (q f32/bf16 x D 64/128/256 each), K8's (D 64/128)
    f16_build = {lib: [e for e in ptxas_entries({lib: reports.get(lib, "")}, entry)
                       if "__half" in e["name"]]
                 for lib, entry in (("paged_attn", "attn_mma_kernel"),
                                    ("flash_attn", "flash_mma_kernel"),
                                    ("paged_decode", "decode_cluster_kernel"),
                                    ("attn_decode_update", "decode_cluster_kernel"),
                                    ("attn_decode", "attn_decode_qkv_kernel"))}
    emit({"phase": "build_f16", "instantiations": f16_build,
          "note": "registers and spills of the f16 KV forms: K10 (attn_mma.cuh), K6 "
                  "(flash_attn.cu), K9 and K8 (decode_cluster.cuh) and K2 (attn_decode.cu)"
                  if any(f16_build.values()) else "not built in this run (cached)"})
    for lib, n_inst in (("paged_attn", 10), ("flash_attn", 6), ("paged_decode", 6),
                        ("attn_decode_update", 4), ("attn_decode", 6)):
        if lib in reports and len(f16_build[lib]) != n_inst:
            fail(f"{lib}: {len(f16_build[lib])} f16 instantiations built, not {n_inst}")
    spills = [e for v in f16_build.values() for e in v if e["spill_stores"] or e["spill_loads"]]
    if spills:
        fail(f"an f16 form spills: {spills}")
    k12k11_build = {lib: ptxas_entries({lib: reports.get(lib, "")}, entry)
                    for lib, entry in (("q4k_matvec_hbm", "q4k_matvec_hbm_kernel"),
                                       ("w4a8dd_matvec", "w4a8dd_kernel"))}
    # K12's ring: stages a warp and a block's shared memory at the paths' K
    k12_layout = {k: dict(zip(("stages", "smem_bytes"), qmm.q4k_matvec_hbm_layout(k)))
                  for k in (2048, 5632, 8192)}
    emit({"phase": "build_k12_k11", "instantiations": k12k11_build, "k12_ring": k12_layout,
          "note": "registers and spills of K12 (csrc/q4k_matvec_hbm.cu: Q4_K/Q4_0/Q4_1 x "
                  "prologue q/norm/glu x f32/bf16; bulk-copy rings of `stages` slots a warp) "
                  "and K11 (csrc/w4a8dd_matvec.cu: Q4_0/Q4_1 x f32/bf16, the quantize fused); "
                  "k12_ring: stages a warp and a block's dynamic shared memory by K"
                  if any(k12k11_build.values()) else "not built in this run (cached)"})
    spills = [e for v in k12k11_build.values() for e in v
              if e["spill_stores"] or e["spill_loads"]]
    if spills:
        fail(f"K12 or K11 spills: {spills}")
    for lib, n_inst in (("q4k_matvec_hbm", 18), ("w4a8dd_matvec", 4)):
        if lib in reports and len(k12k11_build[lib]) != n_inst:
            fail(f"{lib}: {len(k12k11_build[lib])} instantiations built, not {n_inst}")
    # one sliced-loop instantiation a form and decoder: K3's six nibble
    # formats, K5's Q6_K, Q8_0, Q2_K, Q3_K, IQ4 (IQ4_NL and IQ4_XS), MXFP4,
    # IQ2 (32-groups), IQ2 (16-groups: IQ2_XS and IQ2_S), IQ3_XXS, IQ3_S,
    # IQ1_S, IQ1_M and TQ1_0 / TQ2_0 (IQ1CrumbSlice, the last without its
    # min; "CrumbSlice" matches it too)
    for lib, decoders, n_dec in (("q4k_gemm", ("NibbleSlice",), 6),
                                 ("dequant_gemm", ("Q6KSlice", "Q80Slice", "CrumbSlice",
                                                   "TableSlice"), 13)):
        loops = [e for e in ptxas_entries({lib: reports.get(lib, "")}, "slice_gemm_kernel")
                 if any(d in e["name"] for d in decoders)]
        if lib in reports and len(loops) != 2 * n_dec:
            fail(f"{lib}: {len(loops)} sliced-loop instantiations built, not one a form and "
                 "decoder")

    kernels = kernel_wrappers()

    for ftype in ("Q4_K", "Q4_K_M", "Q8_0"):
        small_model_check(torch, ftype)
    for ftype in ("Q5_0", "Q5_1", "Q5_K_M"):  # K1 and K3 in their Q5 forms
        small_model_check(torch, ftype, kernels=kernels, must=("q4k_matvec", "q4k_gemm"))
    for ftype in LOWBIT_FTYPES:  # K4 and K5 in their low-bit forms
        small_model_check(torch, ftype, kernels=kernels, must=("int8_matvec", "dequant_gemm"))
    for ftype in IQ_FTYPES:  # K4 and K5 in the IQ grid forms; IQ1_M's matvecs on K5
        small_model_check(torch, ftype, kernels=kernels,
                          must=("dequant_gemm",) if ftype == "IQ1_M"
                          else ("int8_matvec", "dequant_gemm"))
    for ftype in TQ_FTYPES:  # K4 and K5 in their TQ forms (the head Q6_K)
        small_model_check(torch, ftype, kernels=kernels, must=("int8_matvec", "dequant_gemm"))
    # BF16: every matmul a dense bf16 matrix (torch.matmul), K2 and K6 alone
    small_model_check(torch, "BF16", kernels=kernels, must=("attn_decode_qkv", "flash_attention"))
    for ftype in ("Q4_K", "Q4_K_M"):
        small_model_check(torch, ftype, "small_olmo2", SMALL_OLMO2)
    dualdot = {"ZLLM_QMM_DUALDOT": "1"}
    for env, must in ((None, ("q4k_matvec",)), (dualdot, ("w4a8dd_matvec",))):
        small_model_check(torch, "Q4_0", env=env, kernels=kernels, must=must)
        small_model_check(torch, "Q4_1", "small_olmo2", SMALL_OLMO2, env=env, kernels=kernels,
                          must=must)
    # the Qwen slice's 2-layer files: the decode steps through K1 and K2
    # (qwen3: K2 with the per-head q/k norms; qwen2: the fused norm->wqkv
    # matvec, then its biases)
    for name in ("small_qwen3", "small_qwen2", "small_llama3"):
        small_model_check(torch, "Q4_K", name, SMALL_SHAPES[name], kernels=kernels,
                          must=("q4k_matvec", "attn_decode_qkv"))
    # the f16 KV cache: 2-layer llama and Qwen3 (K2's q/k-norm form at d
    # 128) files through the Generator, K2 and K6 in their f16 forms
    for name in ("small", "small_qwen3"):
        small_model_check(torch, "Q4_K", name, SMALL_SHAPES[name], kernels=kernels,
                          must=("attn_decode_qkv", "flash_attention"), kv_dtype=torch.float16)
    # and a 2-layer OLMo-2 file: K8 and K6 in their f16 forms
    small_model_check(torch, "Q4_K", "small_olmo2", SMALL_OLMO2, kernels=kernels,
                      must=("attn_decode_update", "flash_attention"), kv_dtype=torch.float16)
    tokenizer_roundtrip(card)
    for layout in SMALL_ENGINE_LAYOUTS:
        small_engine_check(torch, kernels, layout)
    olmo2_f16_parity(torch, card)
    # group 10's files and CPU references, after the small models' CPU-heavy
    # checks (beside them, in one run, those took 14-17 s longer each)
    start_moe_children()

    # ---- main paths at TinyLlama geometry -------------------------------
    # every T > 1 step over the contiguous cache (a prefill chunk here)
    # attends column 0 once more through the decode step's kernel, K2 or K8
    def want_q4k(cfg, n_steps, n_chunks):
        L = cfg.n_layers  # wqkv, wo, gate|up, down a layer + the head
        return dict({name: 0 for name in kernels}, q4k_matvec=(4 * L + 1) * n_steps,
                    attn_decode_qkv=L * (n_steps + n_chunks), q4k_gemm=(4 * L + 1) * n_chunks,
                    flash_attention=L * n_chunks)

    def want_olmo2(cfg, n_steps, n_chunks):
        # the same matmuls as want_q4k (K1 with fuse "q" for the layers'
        # four, "norm" for the head), and K8 where llama takes K2
        L = cfg.n_layers
        return dict({name: 0 for name in kernels}, q4k_matvec=(4 * L + 1) * n_steps,
                    attn_decode_update=L * (n_steps + n_chunks),
                    q4k_gemm=(4 * L + 1) * n_chunks, flash_attention=L * n_chunks)

    def want_q4km(cfg, n_steps, n_chunks):
        # Q4_K: wq, wk, wo, gate|up a layer + ffn_down of the last L/2;
        # Q6_K: wv a layer + ffn_down of the first L/2 + the head
        L, low = cfg.n_layers, cfg.n_layers // 2
        k1, k4 = 4 * L + (L - low), L + low + 1
        return dict({name: 0 for name in kernels}, q4k_matvec=k1 * n_steps,
                    int8_matvec=k4 * n_steps, attn_decode_qkv=L * (n_steps + n_chunks),
                    q4k_gemm=k1 * n_chunks, dequant_gemm=k4 * n_chunks,
                    flash_attention=L * n_chunks)

    model, counts_q4k, *_, step_q4k = main_path(torch, "Q4_K", kernels, want_q4k, card)
    model_m, counts_q4km, *_, step_m = main_path(torch, "Q4_K_M", kernels, want_q4km, card)
    model_o, counts_olmo2, gen_o, ids_o, toks_o, step_o = main_path(
        torch, "Q4_K", kernels, want_olmo2, card, name="olmo2")
    L_o = model_o.cfg.n_layers
    counts_hbm = switch_phase(
        torch, gen_o, kernels, ids_o, toks_o, card, phase="olmo2_hbm",
        model="OLMo-2-0425-1B geometry Q4_K (random weights, seed 0)", env="ZLLM_QMM_HBM",
        expected=dict(q4k_matvec_hbm=(4 * L_o + 1) * SWITCH_STEPS,
                      attn_decode_update=L_o * SWITCH_STEPS),
        k1_logits=decode_steps(torch, gen_o, kernels, ids_o, toks_o))
    del gen_o

    # the Q4_0 / Q4_1 slice: TinyLlama geometry in Q4_0 (zllm_torch.quantize
    # from the F16 file: token_embd Q4_K, every matmul Q4_0), K1 then K11
    # under ZLLM_QMM_DUALDOT=1 (the 22 wo matvecs, fuse "q"); OLMo-2
    # geometry in Q4_1 (the factory), K1, then K11 for its 64 fuse-"q"
    # matvecs, then K12 for all 65
    model_40, counts_q40, gen_40, ids_40, toks_40, _ = main_path(torch, "Q4_0", kernels,
                                                                 want_q4k, card)
    L_t = model_40.cfg.n_layers
    counts_q40_dd = switch_phase(
        torch, gen_40, kernels, ids_40, toks_40, card, phase="q4_0_dualdot",
        model="tinyllama-geometry Q4_0 (random weights, seed 0)", env="ZLLM_QMM_DUALDOT",
        expected=dict(w4a8dd_matvec=L_t * SWITCH_STEPS, q4k_matvec=(3 * L_t + 1) * SWITCH_STEPS,
                      attn_decode_qkv=L_t * SWITCH_STEPS),
        k1_logits=decode_steps(torch, gen_40, kernels, ids_40, toks_40))
    del gen_40
    model_o1, counts_o1, gen_o1, ids_o1, toks_o1, _ = main_path(torch, "Q4_1", kernels,
                                                                want_olmo2, card, name="olmo2")
    label_o1 = "OLMo-2-0425-1B geometry Q4_1 (random weights, seed 0)"
    k1_o1 = decode_steps(torch, gen_o1, kernels, ids_o1, toks_o1)
    counts_o1_dd = switch_phase(
        torch, gen_o1, kernels, ids_o1, toks_o1, card, phase="olmo2_q4_1_dualdot", model=label_o1,
        env="ZLLM_QMM_DUALDOT",
        expected=dict(w4a8dd_matvec=4 * L_o * SWITCH_STEPS, q4k_matvec=SWITCH_STEPS,
                      attn_decode_update=L_o * SWITCH_STEPS),
        k1_logits=k1_o1)
    counts_o1_hbm = switch_phase(
        torch, gen_o1, kernels, ids_o1, toks_o1, card, phase="olmo2_q4_1_hbm", model=label_o1,
        env="ZLLM_QMM_HBM",
        expected=dict(q4k_matvec_hbm=(4 * L_o + 1) * SWITCH_STEPS,
                      attn_decode_update=L_o * SWITCH_STEPS),
        k1_logits=k1_o1)
    del gen_o1

    # the Qwen slice at full width and depth: Qwen3-1.7B in Q4_K (per-head
    # q/k norms inside K2), Qwen2.5-1.5B in Q4_K_M by zllm_torch.quantize
    # (q/k/v biases; wq / wk Q4_K and wv Q6_K, so no wqkv; ffn_down K 8960);
    # both tie their head, a dense bf16 matmul outside the kernels
    def want_qwen3(cfg, n_steps, n_chunks):
        L = cfg.n_layers  # wqkv, wo, gate|up, down a layer; no K1 for the head
        return dict({name: 0 for name in kernels}, q4k_matvec=4 * L * n_steps,
                    attn_decode_qkv=L * (n_steps + n_chunks), q4k_gemm=4 * L * n_chunks,
                    flash_attention=L * n_chunks)

    def want_qwen25(cfg, n_steps, n_chunks):
        # Q4_K: wq, wk, wo, gate|up a layer + ffn_down of the last L/2;
        # Q6_K: wv a layer + ffn_down of the first L/2
        L, low = cfg.n_layers, cfg.n_layers // 2
        k1, k4 = 4 * L + (L - low), L + low
        return dict({name: 0 for name in kernels}, q4k_matvec=k1 * n_steps,
                    int8_matvec=k4 * n_steps, attn_decode_qkv=L * (n_steps + n_chunks),
                    q4k_gemm=k1 * n_chunks, dequant_gemm=k4 * n_chunks,
                    flash_attention=L * n_chunks)

    model_q3, counts_q3, gen_q3, *_, step_q3 = main_path(torch, "Q4_K", kernels, want_qwen3,
                                                         card, name="qwen3")
    del gen_q3
    qwen3_step = qwen_step_phase(torch, "Qwen3-1.7B geometry Q4_K", model_q3, step_q3, card)
    model_q25, counts_q25, gen_q25, *_, step_q25 = main_path(torch, "Q4_K_M", kernels,
                                                             want_qwen25, card, name="qwen25")
    del gen_q25
    qwen25_step = qwen_step_phase(torch, "Qwen2.5-1.5B geometry Q4_K_M", model_q25, step_q25,
                                  card)

    # the Q5 slice at TinyLlama geometry: Q5_K_M (zllm_torch.quantize from
    # the F16 file: wq, wk, wo, gate|up, down Q5_K on K1/K3; wv and the head
    # Q6_K on K4/K5), then Q5_0 and Q5_1 (the factory: every matmul, the
    # head too); each then fed the same tokens under ZLLM_QMM_HBM=1 and
    # ZLLM_QMM_DUALDOT=1, which leave a 5-bit weight on K1
    def want_q5km(cfg, n_steps, n_chunks):
        L = cfg.n_layers  # K1: wq, wk, wo, gate|up, down a layer; K4: wv a layer + the head
        return dict({name: 0 for name in kernels}, q4k_matvec=5 * L * n_steps,
                    int8_matvec=(L + 1) * n_steps, attn_decode_qkv=L * (n_steps + n_chunks),
                    q4k_gemm=5 * L * n_chunks, dequant_gemm=(L + 1) * n_chunks,
                    flash_attention=L * n_chunks)

    q5_models, q5_steps, q5_counts = {}, {}, {}
    for ftype, want in (("Q5_K_M", want_q5km), ("Q5_0", want_q4k), ("Q5_1", want_q4k)):
        model_5, counts_5, gen_5, ids_5, toks_5, step_5 = main_path(torch, ftype, kernels, want,
                                                                    card)
        q5_models[ftype], q5_steps[ftype], q5_counts[ftype] = model_5, step_5, counts_5
        k1_logits = decode_steps(torch, gen_5, kernels, ids_5, toks_5)
        per_step = want(model_5.cfg, 1, 0)  # one decode step's launches
        for env, tag in (("ZLLM_QMM_HBM", "hbm"), ("ZLLM_QMM_DUALDOT", "dualdot")):
            phase = f"{ftype.lower()}_{tag}"
            q5_counts[phase] = switch_phase(
                torch, gen_5, kernels, ids_5, toks_5, card, phase=phase,
                model=f"tinyllama-geometry {ftype} (random weights, seed 0)", env=env,
                expected={k: v * SWITCH_STEPS for k, v in per_step.items() if v},
                k1_logits=k1_logits)
        del gen_5

    # the low-bit slice at TinyLlama geometry: Q3_K_M (zllm_torch.quantize
    # from the F16 file: wq, wk, wo, gate|up, down Q3_K on K4/K5; wv Q5_K on
    # K1/K3; the head Q6_K on K4/K5), IQ4_XS (the same way: every matmul
    # IQ4_XS but the Q6_K head, so wq|wk|wv fuse), and Q2_K, IQ4_NL and
    # MXFP4 from the factory (every matmul in the type, the head too)
    def want_q3km(cfg, n_steps, n_chunks):
        L = cfg.n_layers  # K4: wq, wk, wo, gate|up, down a layer + the head; K1: wv
        return dict({name: 0 for name in kernels}, int8_matvec=(5 * L + 1) * n_steps,
                    q4k_matvec=L * n_steps, attn_decode_qkv=L * (n_steps + n_chunks),
                    dequant_gemm=(5 * L + 1) * n_chunks, q4k_gemm=L * n_chunks,
                    flash_attention=L * n_chunks)

    def want_k4_only(cfg, n_steps, n_chunks):
        L = cfg.n_layers  # K4: wqkv, wo, gate|up, down a layer + the head
        return dict({name: 0 for name in kernels}, int8_matvec=(4 * L + 1) * n_steps,
                    attn_decode_qkv=L * (n_steps + n_chunks),
                    dequant_gemm=(4 * L + 1) * n_chunks, flash_attention=L * n_chunks)

    lowbit_models, lowbit_steps, lowbit_counts = {}, {}, {}
    for ftype in LOWBIT_FTYPES:
        model_lb, counts_lb, gen_lb, *_, step_lb = main_path(
            torch, ftype, kernels, want_q3km if ftype == "Q3_K_M" else want_k4_only, card)
        lowbit_models[ftype], lowbit_steps[ftype], lowbit_counts[ftype] = (model_lb, step_lb,
                                                                            counts_lb)
        del gen_lb

    # the IQ grid slice at TinyLlama geometry (the factory's presets: wq, wk,
    # wo, gate|up, down in the type on K4/K5, wv Q4_K and the head Q5_K on
    # K1/K3, so wq, wk and wv stay apart): IQ3_XXS and IQ1_S the full
    # generate, IQ1_M (its matvecs on K5 at M = 1, as zllm runs them) and
    # IQ2_XXS, IQ2_XS, IQ2_S, IQ3_S a short one
    def want_iq(cfg, n_steps, n_chunks):
        L = cfg.n_layers  # K4: wq, wk, wo, gate|up, down a layer; K1: wv a layer + the head
        return dict({name: 0 for name in kernels}, int8_matvec=5 * L * n_steps,
                    q4k_matvec=(L + 1) * n_steps, attn_decode_qkv=L * (n_steps + n_chunks),
                    dequant_gemm=5 * L * n_chunks, q4k_gemm=(L + 1) * n_chunks,
                    flash_attention=L * n_chunks)

    def want_iq1m(cfg, n_steps, n_chunks):
        L = cfg.n_layers  # K5 at M = 1 in K4's place
        return dict(want_iq(cfg, n_steps, n_chunks), int8_matvec=0,
                    dequant_gemm=5 * L * (n_steps + n_chunks))

    iq_models, iq_steps, iq_counts = {}, {}, {}
    for ftype in IQ_FTYPES:
        model_iq, counts_iq, gen_iq, *_, step_iq = main_path(
            torch, ftype, kernels, want_iq1m if ftype == "IQ1_M" else want_iq, card,
            new_tokens=NEW_TOKENS if ftype in ("IQ3_XXS", "IQ1_S") else IQ_SHORT_TOKENS)
        iq_models[ftype], iq_steps[ftype], iq_counts[ftype] = model_iq, step_iq, counts_iq
        del gen_iq

    # the ternary slice at TinyLlama geometry (zllm_torch.quantize from the
    # F16 file: every matmul in the type, so wq|wk|wv and gate|up fuse; the
    # head Q6_K, the embedding Q4_K): IQ4_XS's counts, K4 and K5 in their TQ
    # forms (and K4's Q6_K form for the head); TQ2_0 the full generate, TQ1_0
    # a short one
    tq_models, tq_steps, tq_counts = {}, {}, {}
    for ftype in TQ_FTYPES:
        model_tq, counts_tq, gen_tq, *_, step_tq = main_path(
            torch, ftype, kernels, want_k4_only, card,
            new_tokens=NEW_TOKENS if ftype == "TQ2_0" else IQ_SHORT_TOKENS)
        tq_models[ftype], tq_steps[ftype], tq_counts[ftype] = model_tq, step_tq, counts_tq
        del gen_tq

    # a BF16 file at TinyLlama geometry (zllm_torch.quantize: every matmul
    # and the embedding BF16): dense bf16 weights multiplied by torch.matmul
    # (cast to the activations' dtype, as zllm casts them), no matmul kernel;
    # K2 and K6 carry its attention; a short generate
    def want_dense(cfg, n_steps, n_chunks):
        L = cfg.n_layers
        return dict({name: 0 for name in kernels}, attn_decode_qkv=L * (n_steps + n_chunks),
                    flash_attention=L * n_chunks)

    model_bf16, counts_bf16, gen_bf16, *_, step_bf16 = main_path(
        torch, "BF16", kernels, want_dense, card, new_tokens=IQ_SHORT_TOKENS)
    del gen_bf16
    # the OLMo-2 Q4_K model over a contiguous f16 cache: the bf16 path's
    # counts, every K8 and K6 launch in its f16 form
    _, counts_o16, gen_o16, *_, step_o16 = main_path(torch, "Q4_K", kernels, want_olmo2, card,
                                                     name="olmo2", kv_dtype=torch.float16,
                                                     model=model_o)
    del gen_o16
    # the importance-matrix slice: the collection over the TinyLlama Q8_0
    # file (K5 at M = 1024, K6 with no cache), K5 and K6 at its shapes, the
    # F16 file requantized to IQ2_XXS with that imatrix (the grid fit on the
    # card) and the written file's generate (IQ2_XXS's counts)
    t_im = time.perf_counter()
    model_q8, ids_q8, im_path, counts_imatrix, t_collect = imatrix_phase(torch, kernels, card)
    k_imatrix = kernel_imatrix(torch, model_q8, ids_q8, card)
    del model_q8
    quant_im = quantize_imatrix_phase(torch, kernels, card, im_path, want_iq)
    emit({"phase": "imatrix_slice", "seconds": time.perf_counter() - t_im,
          "collect_s": t_collect, "quantize_s": quant_im["quantize_s"], "card": card})

    counts_serve = serve_phase(torch, model_m, kernels, card)
    counts_q8 = serve_phase(torch, model_m, kernels, card, kv_dtype="q8")
    counts_contig = serve_phase(torch, model_m, kernels, card, kv_layout="contiguous")
    # the f16 KV cache (`--kv-type f16`): the Q4_K_M model's generate over an
    # f16 cache (K2 and K6 in their f16 forms, the bf16 path's counts), then
    # the server on the paged (K9/K10) and contiguous (K2/K6) layouts
    _, counts_q4km16, gen_16, *_, step_m16 = main_path(torch, "Q4_K_M", kernels, want_q4km, card,
                                                       kv_dtype=torch.float16, model=model_m)
    del gen_16
    counts_serve16 = serve_phase(torch, model_m, kernels, card, kv_dtype=torch.float16)
    counts_contig16 = serve_phase(torch, model_m, kernels, card, kv_dtype=torch.float16,
                                  kv_layout="contiguous")
    # the OLMo-2 Q4_K model behind the server over a contiguous f16 cache
    # (`--kv-type f16 --kv-layout contiguous`, 4 slots, S 2176): K8 in its f16
    # form at head_dim 128 with the idle slots' trash rows, K6 in its f16
    # form, K3 at M <= 4 for every matmul and the head
    counts_serve_o16 = serve_phase(torch, model_o, kernels, card, kv_dtype=torch.float16,
                                   kv_layout="contiguous", label="OLMo-2-0425-1B geometry Q4_K",
                                   gemms={"q4k_gemm": 4 * L_o + 1}, tag="olmo2")
    # the TQ2_0 model behind the server (paged, 4 slots): K5's TQ form at M
    # = 4 for wqkv, wo, gate|up and down, and its Q6_K form for the head
    counts_serve_tq = serve_phase(torch, tq_models["TQ2_0"], kernels, card,
                                  label="tinyllama-geometry TQ2_0",
                                  gemms={"dequant_gemm": 4 * L_t + 1}, tag="tq2_0")
    # slot state, the API surface, the router, the prompt cache and the
    # engine's switches over the TinyLlama Q4_K_M model (the router also
    # loads the OLMo-2 Q4_K file)
    slot_counts = {ph: slots_phase(torch, model_m, kernels, card, ph) for ph in SLOT_CASES}
    counts_mit = messages_infill_tools_phase(torch, model_m, kernels, card)
    counts_router = router_phase(torch, kernels, card)
    prompt_cache_phase(card)
    counts_switches = switches_phase(torch, model_m, kernels, card)
    # group 8: speculative decoding, lookahead and the whole-cache shift
    spec = spec_group(torch, model_m, kernels, card)
    # group 11's and group 12's files and CPU references, ahead of them
    start_ln_children()
    start_oss_children()
    # group 9: the Gemma text families (head_dim 256, windows, the ring)
    gemma = gemma_group(torch, kernels, card)
    moe = moe_group(torch, kernels, card)
    # group 11: the layer-norm families (partial neox rope, G 12)
    layernorm = layernorm_group(torch, kernels, card)
    # group 12: gpt-oss (sinks through K2, K6 and K7; the dequantizing route)
    gpt_oss = gpt_oss_group(torch, kernels, card)
    paths = {"Q4_K": counts_q4k, "Q4_K_M": counts_q4km, "olmo2": counts_olmo2,
             "olmo2_hbm": counts_hbm, "Q4_0": counts_q40, "q4_0_dualdot": counts_q40_dd,
             "olmo2_q4_1": counts_o1, "olmo2_q4_1_dualdot": counts_o1_dd,
             "olmo2_q4_1_hbm": counts_o1_hbm, "qwen3": counts_q3, "qwen25": counts_q25,
             **q5_counts, **{ft.lower(): c for ft, c in lowbit_counts.items()},
             **{ft.lower(): c for ft, c in iq_counts.items()},
             "serve": counts_serve, "serve_q8": counts_q8,
             "serve_contig": counts_contig, "Q4_K_M_f16": counts_q4km16,
             "serve_f16": counts_serve16, "serve_contig_f16": counts_contig16,
             **{ft.lower(): c for ft, c in tq_counts.items()}, "bf16": counts_bf16,
             "olmo2_f16": counts_o16, "serve_contig_f16_olmo2": counts_serve_o16,
             "serve_tq2_0": counts_serve_tq, "imatrix": counts_imatrix,
             "iq2_xxs_imatrix": quant_im["counts"], **slot_counts,
             "messages_infill_tools": counts_mit, "router": counts_router,
             "switches": counts_switches, **spec["counts"], **gemma["counts"]}

    # ---- each kernel at the paths' shapes vs its plain version ----------
    cfg = model.cfg
    per_layer = cfg.n_layers
    layers = model.params["layers"]
    head = model.params["output"]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def randn(*shape_, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape_, generator=g, device="cuda") * scale).to(dtype)

    def by_path(name):
        return {p: c[name] for p, c in paths.items()}

    lines = []

    def by_role(n_calls):  # the four matmuls of each layer, then the head
        return {role: list(range(i, n_calls - 1, 4))
                for i, role in enumerate(("wqkv", "wo", "gate_up", "down"))} | {
                    "head": [n_calls - 1]}

    # K1: one Q4_K decode step's 89 matvecs (by role); and the 99 of a Q4_K_M step
    d_model, n_ff = cfg.n_embd, cfg.n_ff
    layers_m, head_m = model_m.params["layers"], model_m.params["output"]

    # the function's own columns: a TinyLlama head is padded to 32768 for
    # the layout, but only the vocabulary's columns count toward the bound
    real_cols = {id(m_.params["output"]): m_.cfg.vocab_size
                 for m_ in (model, model_m, model_40, model_o, model_o1, *q5_models.values(),
                            *lowbit_models.values(), *iq_models.values(), *tq_models.values())}

    def n_real(w):
        return real_cols.get(id(w), w.shape[1])

    x_res = randn(1, d_model, scale=3.0)
    x_att = randn(1, d_model)
    x_gup = randn(1, 2 * n_ff)
    x_h = randn(1, d_model, dtype=torch.bfloat16)  # a normed row in the model dtype
    calls = []
    for layer in layers:
        calls += [(x_res, layer["wqkv"], "norm", layer["attn_norm"]),
                  (x_att, layer["wo"], "q", None),
                  (x_res, layer["ffn_gateup"], "norm", layer["ffn_norm"]),
                  (x_gup, layer["ffn_down"], "glu", None)]
    calls.append((x_res, head, "norm", model.params["out_norm"]))
    calls_m = []
    for layer in layers_m:
        calls_m += [(x_h, layer["wq"], "q", None), (x_h, layer["wk"], "q", None),
                    (x_att, layer["wo"], "q", None),
                    (x_res, layer["ffn_gateup"], "norm", layer["ffn_norm"])]
        if layer["ffn_down"].fmt == GGMLType.Q4_K:
            calls_m.append((x_gup, layer["ffn_down"], "glu", None))
    q4km_k1 = matvec_phase(torch, qmm.q4k_matvec, None, calls_m, n_real,
                           GGUF_BYTES_PER_WEIGHT["Q4_K"], cfg.norm_eps)
    lines.append(dict(name="q4k_matvec", route="cuda", source="zllm_torch/csrc/q4k_matvec.cu",
                      replaces="zllm/ops/qmatmul.py:683", launches=counts_q4k["q4k_matvec"],
                      **matvec_phase(torch, qmm.q4k_matvec, qmm.q4k_matvec_plain, calls, n_real,
                                     GGUF_BYTES_PER_WEIGHT["Q4_K"], cfg.norm_eps,
                                     check=(0, 1, 2, 3, len(calls) - 1),
                                     groups=by_role(len(calls))),
                      tolerance=1e-6, launches_by_path=by_path("q4k_matvec"),
                      unit="one Q4_K decode step (89 launches)",
                      shapes="22 x [wqkv norm 2048->2560, wo q 2048->2048, gate|up norm "
                             "2048->11264, down glu 5632->2048] + head norm 2048->32000 "
                             "(launched padded to 32768)",
                      launches_per_step=len(calls),
                      q4km_step=dict(q4km_k1, launches=len(calls_m),
                                     shapes="22 x [wq, wk q 2048->2048/256 (bf16 x), wo q, "
                                            "gate|up norm] + 11 x down glu")))

    # K2: one decode step's 22 attention blocks at the last decode position
    n_steps = NEW_TOKENS - 1
    pos_v = PROMPT_TOKENS + n_steps
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv3 = randn(1, hq + 2 * hkv, hd)
    kcs = [randn(1, hkv, MAX_LEN, hd, dtype=torch.bfloat16) for _ in layers]
    vcs = [randn(1, hkv, MAX_LEN, hd, dtype=torch.bfloat16) for _ in layers]
    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    rope = rope_table(pos, cfg.rope, hd)
    scale = 1.0 / hd ** 0.5
    kk, vk = kcs[0].clone(), vcs[0].clone()
    kp, vp = kcs[0].clone(), vcs[0].clone()
    a = att.attn_decode_qkv(qkv3, kk, vk, pos, rope, scale=scale, eps=cfg.norm_eps)
    b = att.attn_decode_qkv_plain(qkv3, kp, vp, pos, rope, scale=scale, eps=cfg.norm_eps)
    k2_err = nmse(a.float(), b.float())
    k2_abs = float((a.float() - b.float()).abs().max())
    rest = torch.arange(MAX_LEN, device="cuda") != pos_v
    if not (torch.equal(kk[:, :, rest], kcs[0][:, :, rest])
            and torch.equal(vk[:, :, rest], vcs[0][:, :, rest])):
        fail("K2 wrote cache rows other than its position")
    row_err = nmse(kk[:, :, pos_v].float(), kp[:, :, pos_v].float())
    if row_err > 1e-5 or not torch.equal(vk[:, :, pos_v], vp[:, :, pos_v]):
        fail(f"K2's new cache row differs from its plain version (k nmse {row_err})")

    def k2():
        for kc, vc in zip(kcs, vcs):
            att.attn_decode_qkv(qkv3, kc, vc, pos, rope, scale=scale, eps=cfg.norm_eps)

    def k2_plain():
        for kc, vc in zip(kcs, vcs):
            att.attn_decode_qkv_plain(qkv3, kc, vc, pos, rope, scale=scale, eps=cfg.norm_eps)

    # the yardstick: SDPA on the caches the kernel already inserted into, q
    # roped and rounded outside the timing (attention only: no one call
    # splits, ropes, inserts and attends)
    def sdpa_on_caches(qkv3_, rope_, kcs_, vcs_, pos_vals):
        qr = rope_apply_table(qkv3_[:, :hq].float(), rope_).to(torch.bfloat16)[:, :, None]
        s_ = kcs_[0].shape[2]
        mask = (torch.arange(s_, device="cuda")[None, :]
                <= torch.tensor(pos_vals, device="cuda")[:, None]).reshape(-1, 1, 1, s_)

        def lib():
            for kc_, vc_ in zip(kcs_, vcs_):
                F.scaled_dot_product_attention(qr, kc_, vc_, attn_mask=mask, scale=scale,
                                               enable_gqa=True)
        return lib

    nbytes = per_layer * (2 * hkv * (pos_v + 1) * hd * 2 + qkv3.numel() * 4 + hq * hd * 4)
    ops = per_layer * 4 * hq * (pos_v + 1) * hd
    bms, bby = bound_ms(nbytes, ops, "bf16")
    k2_lib = sdpa_on_caches(qkv3, rope, kcs, vcs, [pos_v])
    k2_calls = cuda_launches(lambda: att.attn_decode_qkv(qkv3, kcs[0], vcs[0], pos, rope,
                                                         scale=scale, eps=cfg.norm_eps))
    if k2_calls not in (None, 1):
        fail(f"K2 launched {k2_calls} CUDA kernels a call, not one")
    k2_line = dict(name="attn_decode_qkv", route="cuda", source="zllm_torch/csrc/attn_decode.cu",
                   replaces="zllm/ops/attention.py:970", launches=counts_q4k["attn_decode_qkv"],
                   max_abs_err=k2_abs, ms=cuda_ms(k2, 20), plain_ms=cuda_ms(k2_plain, 5),
                   bound_ms=bms, bound_by=bby, library_ms=cuda_ms(k2_lib, 20),
                   library="scaled_dot_product_attention on the already-inserted cache, q roped "
                           "outside the timing (attention only)",
                   nmse=k2_err, tolerance=1e-5, launches_by_path=by_path("attn_decode_qkv"),
                   unit="one decode step (22 launches)",
                   shapes=f"qkv3 [1,{hq + 2 * hkv},{hd}] f32, cache [1,{hkv},{MAX_LEN},{hd}] "
                          f"bf16, pos {pos_v}", launches_per_step=per_layer,
                   cuda_launches_per_call=k2_calls if k2_calls is not None else "not measured")
    lines.append(k2_line)
    # a BF16 file's step hands K2 a bf16 qkv (its dense products stay in
    # bf16): the same 22 launches on qkv3 rounded to bf16, held against the
    # plain version, timed for that path's `step_graph` row
    qkv3b = qkv3.to(torch.bfloat16)
    kk, vk, kp, vp = kcs[0].clone(), vcs[0].clone(), kcs[0].clone(), vcs[0].clone()
    a = att.attn_decode_qkv(qkv3b, kk, vk, pos, rope, scale=scale, eps=cfg.norm_eps)
    b = att.attn_decode_qkv_plain(qkv3b, kp, vp, pos, rope, scale=scale, eps=cfg.norm_eps)

    def k2_bf16q():
        for kc, vc in zip(kcs, vcs):
            att.attn_decode_qkv(qkv3b, kc, vc, pos, rope, scale=scale, eps=cfg.norm_eps)

    k2_line["bf16_q"] = dict(ms=cuda_ms(k2_bf16q, 20), nmse=nmse(a.float(), b.float()),
                             max_abs_err=float((a.float() - b.float()).abs().max()),
                             tolerance=1e-5, launches=counts_bf16["attn_decode_qkv"],
                             shapes=f"qkv3 [1,{hq + 2 * hkv},{hd}] bf16, the caches above")
    if not k2_line["bf16_q"]["nmse"] <= 1e-5 or not torch.equal(vk, vp):
        fail(f"K2 with a bf16 q differs from its plain version: {k2_line['bf16_q']}")
    del kcs, vcs

    # K2 at a TinyLlama contiguous engine decode step: 4 rows at 255, 0, 300
    # and a trash row at the stripe's end (S = max_len 2048 + chunk 128),
    # each layer its own caches; output and caches against the plain version
    s2e, pos2e = MAX_LEN + 128, [255, 0, 300, MAX_LEN + 128]
    qkv3e = randn(4, hq + 2 * hkv, hd)
    pose = torch.tensor(pos2e, dtype=torch.int32, device="cuda")
    ropee = rope_table(pose, cfg.rope, hd)
    kcse = [randn(4, hkv, s2e, hd, dtype=torch.bfloat16) for _ in layers]
    vcse = [randn(4, hkv, s2e, hd, dtype=torch.bfloat16) for _ in layers]
    ka, va, kp, vp = kcse[0].clone(), vcse[0].clone(), kcse[0].clone(), vcse[0].clone()
    a = att.attn_decode_qkv(qkv3e, ka, va, pose, ropee, scale=scale, eps=cfg.norm_eps)
    b = att.attn_decode_qkv_plain(qkv3e, kp, vp, pose, ropee, scale=scale, eps=cfg.norm_eps)
    if not (torch.equal(va, vp) and nmse(ka.float(), kp.float()) <= 1e-9):
        fail("K2's engine-step caches differ from its plain version's")

    def k2e(fn):
        def go():
            for kc_, vc_ in zip(kcse, vcse):
                fn(qkv3e, kc_, vc_, pose, ropee, scale=scale, eps=cfg.norm_eps)
        return go

    seen = sum(min(p_ + 1, s2e) for p_ in pos2e)
    nbytes = per_layer * (2 * hkv * seen * hd * 2 + qkv3e.numel() * 4 + 4 * hq * hd * 4)
    bms, bby = bound_ms(nbytes, per_layer * 4 * hq * seen * hd, "bf16")
    k2_line["tinyllama_engine_step"] = dict(
        ms=cuda_ms(k2e(att.attn_decode_qkv), 20),
        plain_ms=cuda_ms(k2e(att.attn_decode_qkv_plain), 2),
        library_ms=cuda_ms(sdpa_on_caches(qkv3e, ropee, kcse, vcse, pos2e), 20), bound_ms=bms,
        bound_by=bby, nmse=nmse(a.float(), b.float()),
        max_abs_err=float((a.float() - b.float()).abs().max()), tolerance=1e-5,
        shapes=f"qkv3 [4,{hq + 2 * hkv},{hd}] f32, cache [4,{hkv},{s2e},{hd}] bf16, pos {pos2e}, "
               f"{per_layer} layers")
    del kcse, vcse

    # K3: one Q4_K prefill chunk's 89 GEMMs at M = 256; and the 99 of Q4_K_M
    m_rows = CHUNK
    xs = {d_model: randn(m_rows, d_model), n_ff: randn(m_rows, n_ff)}
    xh_m = randn(m_rows, d_model, dtype=torch.bfloat16)  # normed rows in the model dtype
    gcalls = []
    for layer in layers:
        gcalls += [(xs[d_model], layer["wqkv"]), (xs[d_model], layer["wo"]),
                   (xs[d_model], layer["ffn_gateup"]), (xs[n_ff], layer["ffn_down"])]
    gcalls.append((xs[d_model], head))
    gcalls_m, roles_m = [], {}
    for layer in layers_m:  # wq, wk, gate|up take normed bf16 rows, wo and down f32
        pairs = [("wq", xh_m), ("wk", xh_m), ("wo", xs[d_model]), ("ffn_gateup", xh_m)]
        if layer["ffn_down"].fmt == GGMLType.Q4_K:
            pairs.append(("ffn_down", xs[n_ff]))
        for role, x in pairs:
            roles_m.setdefault(role, []).append(len(gcalls_m))
            gcalls_m.append((x, layer[role]))
    q4km_k3 = gemm_phase(torch, qmm.q4k_gemm, None, gcalls_m, n_real,
                         GGUF_BYTES_PER_WEIGHT["Q4_K"], groups=roles_m)
    lines.append(dict(name="q4k_gemm", route="cuda", source="zllm_torch/csrc/q4k_gemm.cu",
                      replaces="zllm/ops/qmatmul.py:1402", launches=counts_q4k["q4k_gemm"],
                      loop="zllm_torch/csrc/gemm_slice.cuh",
                      **gemm_phase(torch, qmm.q4k_gemm, qmm.q4k_gemm_plain, gcalls, n_real,
                                   GGUF_BYTES_PER_WEIGHT["Q4_K"],
                                   check=(0, 1, 2, 3, len(gcalls) - 1),
                                   groups=by_role(len(gcalls))),
                      tolerance=1e-6, launches_by_path=by_path("q4k_gemm"),
                      unit="one Q4_K prefill chunk (89 launches)",
                      shapes="M=256 x 22 x [2048->2560, 2048->2048, 2048->11264, 5632->2048] "
                             "+ head 2048->32000 (launched padded to 32768)",
                      launches_per_chunk=len(gcalls),
                      q4km_chunk=dict(q4km_k3, launches=len(gcalls_m))))

    # K6 (bf16 K/V: the tensor-core form): one step's attentions, each layer
    # its own K/V, rows b from starts[b]: a TinyLlama prefill chunk (the
    # second, base 256, 22 layers), an OLMo-2 one (16 layers, 16/16 heads of
    # 128) and a contiguous serve mixed step (chunk 128, rows from 0, 256,
    # 300 and an idle row at 2048, S = 2048 + 128)

    def k6_case(n_layers: int, t: int, hq_: int, hkv_: int, d: int, s: int, starts: list,
                qdtype=torch.float32):
        b = len(starts)
        pos6 = (torch.tensor(starts, dtype=torch.int32, device="cuda")[:, None]
                + torch.arange(t, dtype=torch.int32, device="cuda")[None])
        q6 = randn(b, t, hq_, d, dtype=qdtype)
        kvs = [(randn(b, hkv_, s, d, dtype=torch.bfloat16), randn(b, hkv_, s, d,
                                                                 dtype=torch.bfloat16))
               for _ in range(n_layers)]
        kw6 = dict(scale=d ** -0.5)
        a = att.flash_attention(q6, *kvs[0], pos6, **kw6)
        b_ = att.flash_attention_plain(q6, *kvs[0], pos6, **kw6)

        def run(fn):
            def go():
                for k_, v_ in kvs:
                    fn(q6, k_, v_, pos6, **kw6)
            return go

        q6b = q6.to(torch.bfloat16).transpose(1, 2)
        mask6 = (torch.arange(s, device="cuda")[None, None, :]
                 <= pos6[:, :, None]).reshape(b, 1, t, s)

        def lib():
            for k_, v_ in kvs:
                F.scaled_dot_product_attention(q6b, k_, v_, attn_mask=mask6, enable_gqa=True,
                                               **kw6)

        # slots each row reads (its widest query's span) and the (query,
        # slot) pairs the causal mask lets through, each query its own span
        seen = sum(min(p_ + t - 1, s - 1) + 1 for p_ in starts)
        pairs = sum(min(p_ + i, s - 1) + 1 for p_ in starts for i in range(t))
        nbytes = n_layers * (2 * q6.numel() * q6.element_size() + 2 * hkv_ * seen * d * 2)
        bms, bby = bound_ms(nbytes, n_layers * 4 * hq_ * d * pairs, "bf16")
        return dict(ms=cuda_ms(run(att.flash_attention), 10),
                    plain_ms=cuda_ms(run(att.flash_attention_plain), 2),
                    library_ms=cuda_ms(lib, 10), bound_ms=bms, bound_by=bby,
                    nmse=nmse(a, b_), max_abs_err=float((a - b_).abs().max()), tolerance=1e-5,
                    launches=n_layers,
                    shapes=f"q [{b},{t},{hq_},{d}] {str(qdtype)[6:]} from {starts}, k/v "
                           f"[{b},{hkv_},{s},{d}] bf16, {n_layers} layers")

    cfg_o = model_o.cfg
    # (a bf16 q is one bf16 part where an f32 q is three: the MMAs' share)
    k6 = {"tinyllama_chunk": k6_case(per_layer, CHUNK, hq, hkv, hd, MAX_LEN, [CHUNK]),
          "tinyllama_chunk_bf16_q": k6_case(per_layer, CHUNK, hq, hkv, hd, MAX_LEN, [CHUNK],
                                            torch.bfloat16),
          "olmo2_chunk": k6_case(cfg_o.n_layers, CHUNK, cfg_o.n_heads, cfg_o.n_kv_heads,
                                 cfg_o.head_dim, MAX_LEN, [CHUNK]),
          "serve_contig_mixed_step": k6_case(per_layer, 128, hq, hkv, hd, MAX_LEN + 128,
                                             [0, 256, 300, MAX_LEN]),
          **{f"{label}_chunk": k6_case(m_.cfg.n_layers, CHUNK, m_.cfg.n_heads, m_.cfg.n_kv_heads,
                                       m_.cfg.head_dim, MAX_LEN, [CHUNK])
             for label, m_ in (("qwen3", model_q3), ("qwen25", model_q25))}}
    head6 = k6["tinyllama_chunk"]
    lines.append(dict(name="flash_attention", route="cuda", source="zllm_torch/csrc/flash_attn.cu",
                      replaces="zllm/ops/attention.py:33", launches=counts_q4k["flash_attention"],
                      mma_launches=counts_contig["mma_launches"],
                      **{k: head6[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "nmse", "max_abs_err", "tolerance",
                                               "shapes")},
                      library="scaled_dot_product_attention", form="bf16 or f16 K/V: two passes "
                      "on the tensor cores; f32 K/V: the tile loop attn_tile.cuh",
                      launches_by_path=by_path("flash_attention"),
                      unit="one TinyLlama prefill chunk (22 launches)",
                      launches_per_chunk=per_layer, olmo2_chunk=k6["olmo2_chunk"],
                      bf16_q_chunk=k6["tinyllama_chunk_bf16_q"],
                      serve_contig_mixed_step=k6["serve_contig_mixed_step"],
                      qwen3_chunk=k6["qwen3_chunk"], qwen25_chunk=k6["qwen25_chunk"]))
    bad_k6 = [name for name, r in k6.items() if not r["nmse"] <= r["tolerance"]]

    # K9 / K10 at the serving path's shapes: 4 slots, 16 logical pages of
    # 128 (max_len 2048), 65 physical pages per layer pool, a scrambled table
    # (physical != logical), bf16 pools, f32 q/k/v (the GEMMs' output dtype)
    n_slots, ps, lp = 4, 128, MAX_LEN // 128
    n_pages = n_slots * lp + 1
    table = _paged_table(torch, n_slots, lp, 2)
    pool_shape = (hkv, n_pages * ps, hd)
    kpools = [randn(*pool_shape, dtype=torch.bfloat16) for _ in layers]
    vpools = [randn(*pool_shape, dtype=torch.bfloat16) for _ in layers]
    horizon = lp * ps

    def gathered(pool):  # [B, Hkv, S, D] through the table (outside any timing)
        rows = (table[:, :lp].long()[:, torch.arange(horizon, device="cuda") // ps] * ps
                + torch.arange(horizon, device="cuda") % ps)
        return pool[:, rows.reshape(-1)].reshape(hkv, n_slots, horizon, hd).transpose(0, 1)

    # K9: a page edge, position 0, a mid-page position and a trash row
    pos9 = torch.tensor([[255], [0], [300], [horizon]], dtype=torch.int32, device="cuda")
    q9 = randn(n_slots, 1, hq, hd)
    kn9, vn9 = randn(n_slots, 1, hkv, hd), randn(n_slots, 1, hkv, hd)
    kw9 = dict(page_size=ps, scale=scale)
    ka, va, kb, vb = kpools[0].clone(), vpools[0].clone(), kpools[0].clone(), vpools[0].clone()
    a = att.paged_attn_decode_update(q9, kn9, vn9, ka, va, table, pos9, **kw9)
    b = att.paged_attn_decode_update_plain(q9, kn9, vn9, kb, vb, table, pos9, **kw9)
    live = pos9[:, 0] < horizon
    k9_err = nmse(a[live].float(), b[live].float())
    k9_abs = float((a[live].float() - b[live].float()).abs().max())
    if not (torch.equal(ka[:, ps:], kb[:, ps:]) and torch.equal(va[:, ps:], vb[:, ps:])
            and torch.equal(ka[:, :ps], kpools[0][:, :ps])):
        fail("K9's pools differ from its plain version's outside the trash page "
             "(or it wrote the trash page)")

    def k9():
        for kp_, vp_ in zip(kpools, vpools):
            att.paged_attn_decode_update(q9, kn9, vn9, kp_, vp_, table, pos9, **kw9)

    def k9_plain():
        for kp_, vp_ in zip(kpools, vpools):
            att.paged_attn_decode_update_plain(q9, kn9, vn9, kp_, vp_, table, pos9, **kw9)

    # one call at S = 8320 (65 pages a row): a row at 8000 spans more pages
    # than the cluster's 8 blocks share evenly
    lp_l = 65
    n_pages_l = n_slots * lp_l + 1
    table_l = _paged_table(torch, n_slots, lp_l, 3)
    pos9_l = torch.tensor([[8000], [4100], [0], [lp_l * ps]], dtype=torch.int32, device="cuda")
    kl = randn(hkv, n_pages_l * ps, hd, dtype=torch.bfloat16)
    vl = randn(hkv, n_pages_l * ps, hd, dtype=torch.bfloat16)
    kl2, vl2 = kl.clone(), vl.clone()
    a = att.paged_attn_decode_update(q9, kn9, vn9, kl, vl, table_l, pos9_l, **kw9)
    b = att.paged_attn_decode_update_plain(q9, kn9, vn9, kl2, vl2, table_l, pos9_l, **kw9)
    live_l = pos9_l[:, 0] < lp_l * ps
    k9_long = dict(nmse=nmse(a[live_l].float(), b[live_l].float()), tolerance=1e-6,
                   pools_equal=bool(torch.equal(kl, kl2) and torch.equal(vl, vl2)),
                   shapes=f"pools [{hkv},{n_pages_l * ps},{hd}] bf16, table [{n_slots},"
                          f"{lp_l + 1}] scrambled, pos {pos9_l[:, 0].tolist()}")
    if not (k9_long["nmse"] <= 1e-6 and k9_long["pools_equal"]):
        fail(f"K9 at S = 8320 disagrees with its plain version: {k9_long}")
    del kl, vl, kl2, vl2
    k9_calls = cuda_launches(lambda: att.paged_attn_decode_update(q9, kn9, vn9, kpools[0],
                                                                  vpools[0], table, pos9, **kw9))
    if k9_calls not in (None, 1):
        fail(f"K9 launched {k9_calls} CUDA kernels a call, not one cluster launch")

    # the yardstick: SDPA on the K/V pages gathered (after one K9 call's
    # insert) outside the timing, q rounded to bf16 (attention only)
    kg9 = [gathered(kp_) for kp_ in kpools]
    vg9 = [gathered(vp_) for vp_ in vpools]
    q9b = q9.to(torch.bfloat16).transpose(1, 2)
    mask9 = (torch.arange(horizon, device="cuda")[None, :] <= pos9).reshape(n_slots, 1, 1,
                                                                             horizon)

    def k9_lib():
        for k_, v_ in zip(kg9, vg9):
            F.scaled_dot_product_attention(q9b, k_, v_, attn_mask=mask9, scale=scale,
                                           enable_gqa=True)

    read9 = sum(min(int(p_), horizon - 1) + 1 for p_ in pos9[:, 0].tolist())  # visible slots
    nbytes = per_layer * (2 * hkv * read9 * hd * 2 + (q9.numel() + 2 * kn9.numel()) * 4
                          + q9.numel() * 4 + 2 * int(live.sum()) * hkv * hd * 2)
    ops = per_layer * 4 * hq * read9 * hd
    bms, bby = bound_ms(nbytes, ops, "bf16")
    lines.append(dict(name="paged_attn_decode_update", route="cuda",
                      source="zllm_torch/csrc/paged_decode.cu", replaces="zllm/ops/attention.py:665",
                      launches=counts_serve["paged_attn_decode_update"], max_abs_err=k9_abs,
                      ms=cuda_ms(k9, 20), plain_ms=cuda_ms(k9_plain, 2), bound_ms=bms,
                      bound_by=bby, library_ms=cuda_ms(k9_lib, 20),
                      library="scaled_dot_product_attention on K/V pages gathered outside the "
                              "timing (attention only: no one call inserts and attends through "
                              "a page table)",
                      nmse=k9_err, tolerance=1e-6,
                      launches_by_path=by_path("paged_attn_decode_update"),
                      unit="one serve decode step (22 launches)",
                      shapes=f"q [{n_slots},1,{hq},{hd}] f32, k/v_new [{n_slots},1,{hkv},{hd}] f32, "
                             f"pools [{hkv},{n_pages * ps},{hd}] bf16, table [{n_slots},{lp + 1}] "
                             f"scrambled, pos {pos9[:, 0].tolist()}", launches_per_step=per_layer,
                      cuda_launches_per_call=k9_calls if k9_calls is not None else "not measured",
                      cluster_blocks=att.DECODE_CLUSTER, s8320_check=k9_long,
                      form="one thread-block-cluster launch (csrc/decode_cluster.cuh)"))
    del kg9, vg9

    # K10: one mixed step's attention, chunk 128: rows from 0, from 256 (a
    # page edge), from 300 (mid-page, across a page) and a trash row
    t10 = 128
    pos10 = (torch.tensor([0, 256, 300, horizon], dtype=torch.int32, device="cuda")[:, None]
             + torch.arange(t10, dtype=torch.int32, device="cuda")[None])
    q10 = randn(n_slots, t10, hq, hd)
    kw10 = dict(page_size=ps, scale=scale)
    a = att.paged_attention(q10, kpools[0], vpools[0], table, pos10, **kw10)
    b = att.paged_attention_plain(q10, kpools[0], vpools[0], table, pos10, **kw10)
    live10 = pos10[:, 0] < horizon
    k10_err = nmse(a[live10].float(), b[live10].float())
    k10_abs = float((a[live10] - b[live10]).abs().max())
    kg = [gathered(kp_) for kp_ in kpools]
    vg = [gathered(vp_) for vp_ in vpools]
    q10b = q10.to(torch.bfloat16).transpose(1, 2)
    mask10 = (torch.arange(horizon, device="cuda")[None, None, :]
              <= pos10[:, :, None]).reshape(n_slots, 1, t10, horizon)

    def k10():
        for kp_, vp_ in zip(kpools, vpools):
            att.paged_attention(q10, kp_, vp_, table, pos10, **kw10)

    def k10_plain():
        for kp_, vp_ in zip(kpools, vpools):
            att.paged_attention_plain(q10, kp_, vp_, table, pos10, **kw10)

    def k10_lib():  # SDPA on K/V gathered before the timed window
        for k_, v_ in zip(kg, vg):
            F.scaled_dot_product_attention(q10b, k_, v_, attn_mask=mask10, scale=scale,
                                           enable_gqa=True)

    # slots read per row (its pages), and (query, slot) pairs the causal
    # mask lets through: query t of a row from p0 sees slots 0 .. p0 + t
    reads10 = [min(int(p_) + t10 - 1, horizon - 1) + 1 for p_ in pos10[:, 0].tolist()]
    pairs10 = sum(min(int(p_) + t, horizon - 1) + 1
                  for p_ in pos10[:, 0].tolist() for t in range(t10))
    nbytes = per_layer * (2 * q10.numel() * 4 + 2 * hkv * sum(reads10) * hd * 2)
    ops = per_layer * 4 * hq * pairs10 * hd
    bms, bby = bound_ms(nbytes, ops, "bf16")
    lines.append(dict(name="paged_attention", route="cuda", source="zllm_torch/csrc/paged_attn.cu",
                      replaces="zllm/ops/attention.py:350", launches=counts_serve["paged_attention"],
                      mma_launches=counts_serve["mma_launches"],
                      max_abs_err=k10_abs, ms=cuda_ms(k10, 10), plain_ms=cuda_ms(k10_plain, 2),
                      bound_ms=bms, bound_by=bby, library_ms=cuda_ms(k10_lib, 10),
                      library="scaled_dot_product_attention on K/V gathered outside the timing",
                      nmse=k10_err, tolerance=1e-6, launches_by_path=by_path("paged_attention"),
                      unit="one serve mixed step (22 launches)",
                      shapes=f"q [{n_slots},{t10},{hq},{hd}] f32 from {pos10[:, 0].tolist()}, "
                             f"pools [{hkv},{n_pages * ps},{hd}] bf16, table scrambled",
                      launches_per_step=per_layer))
    del kpools, vpools, kg, vg

    # the f16 forms of K2, K6, K9 and K10 at the same shapes (and K9/K10 at
    # Qwen2.5's G 6, d 128 in bf16 and f16)
    line_f16 = kernel_f16_phase(torch, F, cfg, model_q3.cfg, model_q25.cfg, cfg_o, card,
                                {"tinyllama_q4km_f16_kv": step_m16,
                                 "tinyllama_q4km_bf16_kv": step_m, "olmo2_q4k_f16_kv": step_o16,
                                 "olmo2_q4k_bf16_kv": step_o})

    # K7 at the q8 serving path's shapes: 4 slots, S = 2176 (max_len 2048 +
    # chunk 128), f32 q (the GEMMs' output dtype), one step's 22 layers, each
    # its own K/V: a decode step (rows at 255, 0, 300 and a trash row at
    # 2048) and a mixed step (chunk 128, rows from 0, 256, 300 and a trash
    # row), over int8 codes with f32 scales (the q8 cache) and over bf16 K/V
    s7 = MAX_LEN + 128
    gen7 = torch.Generator(device="cuda")
    gen7.manual_seed(7)

    def codes():
        return torch.randint(-127, 128, (n_slots, hkv, s7, hd), generator=gen7, device="cuda",
                             dtype=torch.int8)

    def scales():
        return randn(n_slots, hkv, s7, 1).abs() * 0.01 + 1e-3

    kv7 = {"int8": [(codes(), codes(), scales(), scales()) for _ in layers],
           "bf16": [(randn(n_slots, hkv, s7, hd, dtype=torch.bfloat16),
                     randn(n_slots, hkv, s7, hd, dtype=torch.bfloat16), None, None)
                    for _ in layers]}

    # one split-form call at S = 8320 (65 chunks a row), int8 K/V, a row at 8000
    s7l = 8320
    pos7_l = torch.tensor([[8000], [4100], [0], [s7l]], dtype=torch.int32, device="cuda")
    q7l = randn(n_slots, 1, hq, hd)
    k7l = torch.randint(-127, 128, (n_slots, hkv, s7l, hd), generator=gen7, device="cuda",
                        dtype=torch.int8)
    v7l = torch.randint(-127, 128, (n_slots, hkv, s7l, hd), generator=gen7, device="cuda",
                        dtype=torch.int8)
    ks7l = randn(n_slots, hkv, s7l, 1).abs() * 0.01 + 1e-3
    vs7l = randn(n_slots, hkv, s7l, 1).abs() * 0.01 + 1e-3
    a = att.flash_attention_blockwise(q7l, k7l, v7l, pos7_l, scale=scale, ks=ks7l, vs=vs7l)
    b = att.flash_attention_blockwise_plain(q7l, k7l, v7l, pos7_l, scale=scale, ks=ks7l,
                                            vs=vs7l)
    k7_long = dict(nmse=nmse(a, b), tolerance=1e-6,
                   shapes=f"q [{n_slots},1,{hq},{hd}] f32 at {pos7_l[:, 0].tolist()}, k/v "
                          f"[{n_slots},{hkv},{s7l},{hd}] int8 + f32 scales")
    if not k7_long["nmse"] <= 1e-6:
        fail(f"K7's split form at S = 8320 disagrees with its plain version: {k7_long}")
    del k7l, v7l, ks7l, vs7l

    dec7, mix7 = [255, 0, 300, MAX_LEN], [0, 256, 300, MAX_LEN]
    pos7_dec = torch.tensor(dec7, dtype=torch.int32, device="cuda")[:, None]
    k_, v_, ks_, vs_ = kv7["int8"][0]
    k7_calls = cuda_launches(lambda: att.flash_attention_blockwise(
        q7l, k_, v_, pos7_dec, scale=scale, ks=ks_, vs=vs_))
    if k7_calls not in (None, 1):
        fail(f"K7's split form launched {k7_calls} CUDA kernels a call, not one cluster launch")
    k7 = {f"{form}_{step}": k7_case(torch, F, randn, kv7[form], t7, starts, hq, scale)
          for form in ("int8", "bf16") for step, t7, starts in (("decode", 1, dec7),
                                                                  ("mixed", 128, mix7))}
    head7 = k7["int8_decode"]
    lines.append(dict(name="flash_attention_blockwise", route="cuda",
                      source="zllm_torch/csrc/attn_blockwise.cu",
                      replaces="zllm/ops/attention.py:165",
                      launches=counts_q8["flash_attention_blockwise"],
                      mma_launches=counts_q8["mma_launches"],
                      **{k: head7[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "nmse", "max_abs_err", "tolerance",
                                               "shapes")},
                      library="scaled_dot_product_attention on K/V dequantized to bf16 outside "
                              "the timing",
                      launches_by_path=by_path("flash_attention_blockwise"),
                      unit="one serve_q8 decode step (22 launches), int8 K/V",
                      launches_per_step=per_layer,
                      serve_q8_mixed_step=k7["int8_mixed"], bf16_decode_step=k7["bf16_decode"],
                      bf16_mixed_step=k7["bf16_mixed"],
                      cuda_launches_per_call=k7_calls if k7_calls is not None else "not measured",
                      cluster_blocks=att.DECODE_CLUSTER, s8320_check=k7_long,
                      form="split (R <= 32): one thread-block-cluster launch "
                           "(csrc/decode_cluster.cuh); mixed: attn_mma.cuh"))
    bad_k7 = [name for name, r in k7.items() if not r["nmse"] <= r["tolerance"]]
    del kv7

    # K8: one OLMo-2 decode step's 16 attentions (B = 1, 16/16 heads of 128,
    # the Generator's bf16 cache of 2048 slots, pos 331 = the last step's),
    # each layer its own cache; and one TinyLlama-geometry contiguous engine
    # decode step (4 rows at 255, 0, 300 and a trash row at max_len 2048, in
    # the engine's stripe of 2048 + 128 slots, 32/4 heads of 64, G = 8)
    def k8_case(n_layers: int, b: int, hq_: int, hkv_: int, d: int, s: int, pos_vals: list):
        pos8 = torch.tensor(pos_vals, dtype=torch.int32, device="cuda")[:, None]
        q8_ = randn(b, 1, hq_, d)
        kn8, vn8 = randn(b, 1, hkv_, d), randn(b, 1, hkv_, d)
        kcs8 = [randn(b, hkv_, s, d, dtype=torch.bfloat16) for _ in range(n_layers)]
        vcs8 = [randn(b, hkv_, s, d, dtype=torch.bfloat16) for _ in range(n_layers)]
        kw8 = dict(scale=d ** -0.5)
        ka, va, kb, vb = kcs8[0].clone(), vcs8[0].clone(), kcs8[0].clone(), vcs8[0].clone()
        a = att.attn_decode_update(q8_, kn8, vn8, ka, va, pos8, **kw8)
        b_ = att.attn_decode_update_plain(q8_, kn8, vn8, kb, vb, pos8, **kw8)
        if not (torch.equal(ka, kb) and torch.equal(va, vb)):
            fail("K8's updated caches differ from its plain version's")

        def run(fn):
            def go():
                for kc_, vc_ in zip(kcs8, vcs8):
                    fn(q8_, kn8, vn8, kc_, vc_, pos8, **kw8)
            return go

        qb = q8_.to(torch.bfloat16).transpose(1, 2)  # [B, Hq, 1, D]
        mask8 = (torch.arange(s, device="cuda")[None, :] <= pos8).reshape(b, 1, 1, s)

        def lib():  # SDPA on the caches the kernel already inserted into
            for kc_, vc_ in zip(kcs8, vcs8):
                F.scaled_dot_product_attention(qb, kc_, vc_, attn_mask=mask8, scale=kw8["scale"],
                                               enable_gqa=True)

        seen = sum(min(p_ + 1, s) for p_ in pos_vals)  # the slots each row attends
        nbytes = n_layers * (2 * hkv_ * seen * d * 2 + (q8_.numel() + 2 * kn8.numel()) * 4
                             + q8_.numel() * 4 + 2 * b * hkv_ * d * 2)
        bms, bby = bound_ms(nbytes, n_layers * 4 * hq_ * seen * d, "bf16")
        return dict(ms=cuda_ms(run(att.attn_decode_update), 20),
                    plain_ms=cuda_ms(run(att.attn_decode_update_plain), 2),
                    library_ms=cuda_ms(lib, 20), bound_ms=bms, bound_by=bby,
                    nmse=nmse(a.float(), b_.float()),
                    max_abs_err=float((a.float() - b_.float()).abs().max()), tolerance=1e-6,
                    shapes=f"q [{b},1,{hq_},{d}] f32, k/v_new [{b},1,{hkv_},{d}] f32, cache "
                           f"[{b},{hkv_},{s},{d}] bf16, pos {pos_vals}, {n_layers} layers")

    k8_o = k8_case(cfg_o.n_layers, 1, cfg_o.n_heads, cfg_o.n_kv_heads, cfg_o.head_dim, MAX_LEN,
                   [pos_v])
    k8_t = k8_case(per_layer, 4, hq, hkv, hd, MAX_LEN + 128, [255, 0, 300, MAX_LEN])

    # K8 once at S = 2000 (not a multiple of the 128-slot chunk; a row at
    # its last slot) and once at S = 8320 (65 chunks over the cluster's 8
    # blocks, a trash row): output and caches against the plain version
    def k8_check(b, hq_, hkv_, d, s, pos_vals):
        pos8 = torch.tensor(pos_vals, dtype=torch.int32, device="cuda")[:, None]
        q8_, kn8, vn8 = randn(b, 1, hq_, d), randn(b, 1, hkv_, d), randn(b, 1, hkv_, d)
        ka = randn(b, hkv_, s, d, dtype=torch.bfloat16)
        va = randn(b, hkv_, s, d, dtype=torch.bfloat16)
        kb, vb = ka.clone(), va.clone()
        a = att.attn_decode_update(q8_, kn8, vn8, ka, va, pos8, scale=d ** -0.5)
        b_ = att.attn_decode_update_plain(q8_, kn8, vn8, kb, vb, pos8, scale=d ** -0.5)
        return dict(nmse=nmse(a.float(), b_.float()), tolerance=1e-6,
                    caches_equal=bool(torch.equal(ka, kb) and torch.equal(va, vb)),
                    shapes=f"q [{b},1,{hq_},{d}] f32, cache [{b},{hkv_},{s},{d}] bf16, "
                           f"pos {pos_vals}")

    k8_long = {"s2000": k8_check(1, cfg_o.n_heads, cfg_o.n_kv_heads, cfg_o.head_dim, 2000,
                                 [1999]),
               "s8320": k8_check(4, hq, hkv, hd, 8320, [8000, 4100, 0, 8320])}
    bad = {k: r for k, r in k8_long.items() if not (r["nmse"] <= 1e-6 and r["caches_equal"])}
    if bad:
        fail(f"K8 disagrees with its plain version: {bad}")
    q8c, kn8c = randn(1, 1, cfg_o.n_heads, cfg_o.head_dim), randn(1, 1, cfg_o.n_kv_heads,
                                                                  cfg_o.head_dim)
    kc8c = randn(1, cfg_o.n_kv_heads, MAX_LEN, cfg_o.head_dim, dtype=torch.bfloat16)
    vc8c = kc8c.clone()
    pos8c = torch.tensor([[pos_v]], dtype=torch.int32, device="cuda")
    k8_calls = cuda_launches(lambda: att.attn_decode_update(
        q8c, kn8c, kn8c, kc8c, vc8c, pos8c, scale=cfg_o.head_dim ** -0.5))
    if k8_calls not in (None, 1):
        fail(f"K8 launched {k8_calls} CUDA kernels a call, not one cluster launch")
    lines.append(dict(name="attn_decode_update", route="cuda",
                      source="zllm_torch/csrc/attn_decode_update.cu",
                      replaces="zllm/ops/attention.py:499",
                      launches=counts_olmo2["attn_decode_update"], **k8_o,
                      library="scaled_dot_product_attention on the already-inserted cache "
                              "(attention only: no one call inserts and attends)",
                      launches_by_path=by_path("attn_decode_update"),
                      unit=f"one OLMo-2 decode step ({cfg_o.n_layers} launches)",
                      launches_per_step=cfg_o.n_layers, tinyllama_engine_step=k8_t,
                      cuda_launches_per_call=k8_calls if k8_calls is not None else "not measured",
                      cluster_blocks=att.DECODE_CLUSTER, long_checks=k8_long,
                      max_active_clusters=k8_occupancy,
                      form="one thread-block-cluster launch (csrc/decode_cluster.cuh)",
                      f16_olmo2_step=line_f16["attn_decode_update"]["olmo2_step"],
                      f16_tinyllama_engine_step=line_f16["attn_decode_update"][
                          "tinyllama_engine_step"]))
    bad_k8 = [] if k8_t["nmse"] <= k8_t["tolerance"] else ["tinyllama_engine_step"]

    # K12 over one OLMo-2 decode step's 65 Q4_K matvecs (the layers' four
    # with fuse "q" on the raw stream, the head with the final norm) and the
    # TinyLlama Q4_K step's 89, with K1 on the same calls in this run
    layers_o, head_o = model_o.params["layers"], model_o.params["output"]
    x_o, x_ffo = randn(1, cfg_o.n_embd, scale=3.0), randn(1, cfg_o.n_ff)
    calls_o = []
    for layer in layers_o:
        calls_o += [(x_o, layer["wqkv"], "q", None), (x_o, layer["wo"], "q", None),
                    (x_o, layer["ffn_gateup"], "q", None), (x_ffo, layer["ffn_down"], "q", None)]
    calls_o.append((x_o, head_o, "norm", model_o.params["out_norm"]))
    bpw4 = GGUF_BYTES_PER_WEIGHT["Q4_K"]
    check_o = (0, 1, 2, 3, len(calls_o) - 1)

    k12_o = matvec_phase(torch, qmm.q4k_matvec_hbm, qmm.q4k_matvec_hbm_plain, calls_o, n_real,
                         bpw4, cfg_o.norm_eps, check=check_o, groups=by_role(len(calls_o)))
    k1_o = matvec_phase(torch, qmm.q4k_matvec, None, calls_o, n_real, bpw4, cfg_o.norm_eps,
                        groups=by_role(len(calls_o)))
    k12_t = matvec_phase(torch, qmm.q4k_matvec_hbm, None, calls, n_real, bpw4, cfg.norm_eps,
                         groups=by_role(len(calls)))
    k1_t = matvec_phase(torch, qmm.q4k_matvec, None, calls, n_real, bpw4, cfg.norm_eps,
                        groups=by_role(len(calls)))
    bitwise = all(torch.equal(qmm.q4k_matvec_hbm(x, w, fuse, aux, eps_),
                              qmm.q4k_matvec(x, w, fuse, aux, eps_))
                  for (x, w, fuse, aux), eps_ in
                  [(calls_o[i], cfg_o.norm_eps) for i in check_o]
                  + [(calls[i], cfg.norm_eps) for i in (0, 1, 2, 3, len(calls) - 1)])
    k12_calls = cuda_launches(lambda: qmm.q4k_matvec_hbm(*calls_o[0], cfg_o.norm_eps))
    if k12_calls not in (None, 1):
        fail(f"K12 launched {k12_calls} CUDA kernels a call, not one")
    lines.append(dict(name="q4k_matvec_hbm", route="cuda", source="zllm_torch/csrc/q4k_matvec_hbm.cu",
                      replaces="zllm/ops/qmatmul.py:1170", launches=counts_hbm["q4k_matvec_hbm"],
                      **k12_o, tolerance=1e-6, bitwise_equal_k1=bitwise,
                      launches_by_path=by_path("q4k_matvec_hbm"),
                      cuda_launches_per_call=k12_calls if k12_calls is not None
                      else "not measured", ring=k12_layout,
                      unit=f"one OLMo-2 decode step ({len(calls_o)} launches)",
                      shapes="16 x [wqkv 2048->6144, wo 2048->2048, gate|up 2048->16384, down "
                             "8192->2048] (fuse q) + head norm 2048->100352",
                      k1_same_calls_ms=k1_o["ms"], k1_ms_by_group=k1_o["ms_by_group"],
                      tinyllama_q4k_step=dict(ms=k12_t["ms"], k1_ms=k1_t["ms"],
                                              ms_by_group=k12_t["ms_by_group"],
                                              k1_ms_by_group=k1_t["ms_by_group"],
                                              bound_ms=k12_t["bound_ms"], launches=len(calls))))
    if not bitwise:
        fail("K12 differs from K1 bit for bit on the same calls")

    # K1, K3, K12 in their Q4_0 / Q4_1 forms and K11, at the two new main
    # paths' steps and chunks: TinyLlama Q4_0 (89 matvecs: K1, K12; its 22
    # wo: K11 beside K1) and OLMo-2 Q4_1 (65 matvecs: K1, K12; its 64
    # fuse-"q" ones: K11 beside K1)
    calls_40 = []
    for layer in model_40.params["layers"]:
        calls_40 += [(x_res, layer["wqkv"], "norm", layer["attn_norm"]),
                     (x_att, layer["wo"], "q", None),
                     (x_res, layer["ffn_gateup"], "norm", layer["ffn_norm"]),
                     (x_gup, layer["ffn_down"], "glu", None)]
    calls_40.append((x_res, model_40.params["output"], "norm", model_40.params["out_norm"]))
    calls_o1 = []
    for layer in model_o1.params["layers"]:
        calls_o1 += [(x_o, layer["wqkv"], "q", None), (x_o, layer["wo"], "q", None),
                     (x_o, layer["ffn_gateup"], "q", None), (x_ffo, layer["ffn_down"], "q", None)]
    calls_o1.append((x_o, model_o1.params["output"], "norm", model_o1.params["out_norm"]))
    xs_o = {cfg_o.n_embd: randn(m_rows, cfg_o.n_embd), cfg_o.n_ff: randn(m_rows, cfg_o.n_ff)}
    legacy = {  # form -> (step calls, eps, GGUF bytes a weight, chunk calls)
        "q4_0": (calls_40, cfg.norm_eps, GGUF_BYTES_PER_WEIGHT["Q4_0"],
                 [(xs[w.shape[0]], w) for _, w, _, _ in calls_40]),
        "olmo2_q4_1": (calls_o1, cfg_o.norm_eps, GGUF_BYTES_PER_WEIGHT["Q4_1"],
                       [(xs_o[w.shape[0]], w) for _, w, _, _ in calls_o1]),
    }

    def dd(x, w, fuse, aux, eps):  # K11 and its plain version in matvec_phase's form
        return qmm.w4a8dd_matvec(x, w)

    def dd_plain(x, w, fuse, aux, eps):
        return qmm.w4a8dd_matvec_plain(*qmm.quantize_acts_plain(x), w)

    legacy_lines, bad_legacy = {}, []
    for form, (lcalls, leps, bpw, lgcalls) in legacy.items():
        last = len(lcalls) - 1
        dd_idx = [i for i, c in enumerate(lcalls) if c[2] == "q"]
        dd_calls = [lcalls[i] for i in dd_idx]
        k1 = matvec_phase(torch, qmm.q4k_matvec, qmm.q4k_matvec_plain, lcalls, n_real, bpw, leps,
                          check=(0, 1, 2, 3, last))
        k12 = matvec_phase(torch, qmm.q4k_matvec_hbm, None, lcalls, n_real, bpw, leps)
        k3 = gemm_phase(torch, qmm.q4k_gemm, qmm.q4k_gemm_plain, lgcalls, n_real, bpw,
                        check=(0, 1, 2, 3, last), groups=by_role(len(lgcalls)))
        k11 = matvec_phase(torch, dd, dd_plain, dd_calls, n_real, bpw, leps,
                           check=(0, 1, len(dd_calls) - 1))
        k1_dd = matvec_phase(torch, qmm.q4k_matvec, None, dd_calls, n_real, bpw, leps)
        k12_same = all(torch.equal(qmm.q4k_matvec_hbm(x, w, f, a, leps),
                                   qmm.q4k_matvec(x, w, f, a, leps))
                       for x, w, f, a in (lcalls[i] for i in (0, 1, 2, 3, last)))
        k11_same = all(torch.equal(dd(x, w, f, a, leps), qmm.q4k_matvec(x, w, f, a, leps))
                       for x, w, f, a in (dd_calls[i] for i in (0, 1, len(dd_calls) - 1)))
        legacy_lines[form] = dict(
            k1=dict(k1, launches=len(lcalls)), k3=dict(k3, launches=len(lgcalls)),
            k12=dict(k12, launches=len(lcalls), k1_ms=k1["ms"], bitwise_equal_k1=k12_same),
            k11=dict(k11, launches=len(dd_calls), k1_same_calls_ms=k1_dd["ms"],
                     bitwise_equal_k1=k11_same))
        bad_legacy += [f"{form} {name}" for name, r in
                       (("K1", k1), ("K3", k3), ("K11", k11)) if not r["nmse"] <= 1e-6]
        bad_legacy += [f"{form} {name} != K1" for name, same in (("K12", k12_same),
                                                                 ("K11", k11_same)) if not same]

    k11_t = legacy_lines["q4_0"]["k11"]
    k11_calls = cuda_launches(lambda: qmm.w4a8dd_matvec(x_att, model_40.params["layers"][0]["wo"]))
    if k11_calls not in (None, 1):
        fail(f"K11 launched {k11_calls} CUDA kernels a call, not one")
    lines.append(dict(name="w4a8dd_matvec", route="cuda", source="zllm_torch/csrc/w4a8dd_matvec.cu",
                      replaces="zllm/ops/qmatmul.py:902",
                      launches=counts_q40_dd["w4a8dd_matvec"],
                      **{k: k11_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "nmse", "max_abs_err",
                                               "k1_same_calls_ms", "bitwise_equal_k1")},
                      tolerance=1e-6, launches_by_path=by_path("w4a8dd_matvec"),
                      cuda_launches_per_call=k11_calls if k11_calls is not None
                      else "not measured",
                      unit=f"one TinyLlama Q4_0 decode step's {k11_t['launches']} wo matvecs",
                      shapes="22 x wo 2048->2048 Q4_0, x f32",
                      olmo2_q4_1_step=dict(legacy_lines["olmo2_q4_1"]["k11"],
                                           shapes="16 x [wqkv 2048->6144, wo 2048->2048, "
                                                  "gate|up 2048->16384, down 8192->2048] Q4_1")))
    by_name = {ln["name"]: ln for ln in lines}
    for name, key in (("q4k_matvec", "k1"), ("q4k_gemm", "k3"), ("q4k_matvec_hbm", "k12")):
        by_name[name]["q4_0_tinyllama"] = legacy_lines["q4_0"][key]
        by_name[name]["q4_1_olmo2"] = legacy_lines["olmo2_q4_1"][key]

    # the matmul kernels by weight role on a TinyLlama step's and chunk's
    # weights of one format: K1 and K3 on the Q5_K_M step's 110 Q5_K
    # matvecs and the Q5_0 and Q5_1 steps' 89; K4 and K5 on the Q3_K_M
    # step's 110 Q3_K matvecs and its Q6_K head, and the IQ4_XS, Q2_K,
    # IQ4_NL and MXFP4 steps' 89
    def role_calls(model_, all_heads: bool):
        """The step's matvec calls [(x, w, fuse, aux)] on `model_`'s matmul
        weights, its chunk's GEMM calls [(x, w)] and the call indices of each
        weight role.  A fused file's wqkv takes the raw residual with "norm";
        a split file's wq and wk the bf16 normed row, as in the step (its wv
        is in another format, on another kernel).  The head joins as "head"
        when it is in the matmuls' format, and with `all_heads` also when it
        is not, as "head FMT"."""
        mcalls, gcalls_, roles = [], [], {}
        for layer in model_.params["layers"]:
            if "wqkv" in layer:
                qkv = [("wqkv", (x_res, layer["wqkv"], "norm", layer["attn_norm"]),
                        xs[d_model])]
            else:
                qkv = [(r, (x_h, layer[r], "q", None), xh_m) for r in ("wq", "wk")]
            for role, c, xg in qkv + [
                    ("wo", (x_att, layer["wo"], "q", None), xs[d_model]),
                    ("gate_up", (x_res, layer["ffn_gateup"], "norm", layer["ffn_norm"]),
                     xh_m if "wq" in layer else xs[d_model]),
                    ("down", (x_gup, layer["ffn_down"], "glu", None), xs[n_ff])]:
                roles.setdefault(role, []).append(len(mcalls))
                mcalls.append(c)
                gcalls_.append((xg, c[1]))
        head_ = model_.params["output"]
        same = head_.fmt == mcalls[0][1].fmt
        if same or all_heads:
            roles["head" if same else f"head {head_.fmt.name}"] = [len(mcalls)]
            mcalls.append((x_res, head_, "norm", model_.params["out_norm"]))
            gcalls_.append((xs[d_model], head_))
        return mcalls, gcalls_, roles

    def role_lines(model_, kernels, keys, all_heads: bool, m4: bool, m1: bool = False) -> dict:
        """The matvec and GEMM of `kernels` ((wrapper, plain) each, named by
        `keys`) on role_calls(model_, all_heads), by weight role: bounded by
        each weight's GGUF bytes (the layout's bytes a weight beside them),
        held against the plain versions on the first five calls, each role's
        first and the last; with `m4` the GEMM also at the engine's decode
        M = 4 (one row per slot); with `m1` the step's matvecs are the GEMM
        at M = 1 (IQ1_M's, which K4 does not take)."""
        mcalls, gcalls_, roles = role_calls(model_, all_heads)
        (mv, mv_plain), (gm, gm_plain) = kernels
        check = tuple(sorted({*range(5), *(idx[0] for idx in roles.values()), len(mcalls) - 1}))
        fmt = mcalls[0][1].fmt.name
        nw = sum(w.shape[0] * n_real(w) for _, w, _, _ in mcalls)
        layout = sum(w.nbytes * n_real(w) / w.shape[1] for _, w, _, _ in mcalls) / nw
        if m1:
            g1 = [(x[:1], w) for x, w in gcalls_]
            step = dict(gemm_phase(torch, gm, gm_plain, g1, n_real, None, check=check,
                                   groups=roles), m=1)
        else:
            step = matvec_phase(torch, mv, mv_plain, mcalls, n_real, None, cfg.norm_eps,
                                check=check, groups=roles)
        out = {keys[0]: dict(step, launches=len(mcalls), fmt=fmt, layout_bytes_per_weight=layout,
                             tolerance=1e-6),
               keys[1]: dict(gemm_phase(torch, gm, gm_plain, gcalls_, n_real, None, check=check,
                                        groups=roles),
                             launches=len(gcalls_), m=m_rows, fmt=fmt,
                             layout_bytes_per_weight=layout, tolerance=1e-6)}
        if m4:
            g4 = [(x[:4], w) for x, w in gcalls_]
            out[keys[1] + "_m4"] = dict(
                gemm_phase(torch, gm, gm_plain, g4, n_real, None, check=(0, len(g4) - 1),
                           groups=roles),
                launches=len(g4), m=4, fmt=fmt, tolerance=1e-6)
        return out

    def failed(lines_):
        return [f"{ft} {key}" for ft, ln in lines_.items() for key, r in ln.items()
                if not r["nmse"] <= r["tolerance"]]

    k1_k3 = ((qmm.q4k_matvec, qmm.q4k_matvec_plain), (qmm.q4k_gemm, qmm.q4k_gemm_plain))
    k4_k5 = ((qmm.int8_matvec, qmm.int8_matvec_plain),
             (qmm.dequant_gemm, qmm.dequant_gemm_plain))
    q5_lines = {ft: role_lines(q5_models[ft], k1_k3, ("k1", "k3"), all_heads=False,
                               m4=ft == "Q5_K_M") for ft in ("Q5_K_M", "Q5_0", "Q5_1")}
    # and K4 on the Q5_K_M step's 23 Q6_K matvecs: wv a layer, the head
    model_5 = q5_models["Q5_K_M"]
    calls6 = [(x_h, layer["wv"], "q", None) for layer in model_5.params["layers"]]
    calls6.append((x_res, model_5.params["output"], "norm", model_5.params["out_norm"]))
    q5_lines["Q5_K_M"]["k4"] = dict(
        matvec_phase(torch, qmm.int8_matvec, qmm.int8_matvec_plain, calls6, n_real,
                     GGUF_BYTES_PER_WEIGHT["Q6_K"], cfg.norm_eps, check=(0, len(calls6) - 1)),
        launches=len(calls6), fmt="Q6_K", tolerance=1e-6)
    bad_q5 = failed(q5_lines)
    emit({"phase": "kernel_q5", "card": card,
          "shapes": "TinyLlama geometry: Q5_K_M 22 x [wq, wk q 2048->2048/256 (bf16 x), wo q "
                    "2048->2048, gate|up norm 2048->11264, down glu 5632->2048]; Q5_0 and Q5_1 "
                    "22 x [wqkv norm 2048->2560, wo, gate|up, down] + head norm 2048->32000 "
                    "(launched padded to 32768); K3 the same weights at M = 256 (and 4)",
          **q5_lines})
    for name, key in (("q4k_matvec", "k1"), ("q4k_gemm", "k3")):
        for ftype, ln in q5_lines.items():
            by_name[name][f"{ftype.lower()}_tinyllama"] = ln[key]
    by_name["q4k_gemm"]["q5_k_m_tinyllama_m4"] = q5_lines["Q5_K_M"]["k3_m4"]

    lowbit_lines = {ft: role_lines(lowbit_models[ft], k4_k5, ("k4", "k5"), all_heads=True,
                                   m4=ft == "Q3_K_M") for ft in LOWBIT_FTYPES}
    # and K1 on the Q3_K_M step's 22 Q5_K wv matvecs (the bf16 normed row)
    wv_calls = [(x_h, layer["wv"], "q", None)
                for layer in lowbit_models["Q3_K_M"].params["layers"]]
    lowbit_lines["Q3_K_M"]["k1_wv"] = dict(
        matvec_phase(torch, qmm.q4k_matvec, qmm.q4k_matvec_plain, wv_calls, n_real,
                     GGUF_BYTES_PER_WEIGHT["Q5_K"], cfg.norm_eps, check=(0,)),
        launches=len(wv_calls), fmt="Q5_K", tolerance=1e-6)
    bad_lowbit = failed(lowbit_lines)
    emit({"phase": "kernel_lowbit", "card": card,
          "shapes": "TinyLlama geometry: Q3_K_M 22 x [wq, wk q 2048->2048/256 (bf16 x), wo q "
                    "2048->2048, gate|up norm 2048->11264, down glu 5632->2048] Q3_K + head "
                    "norm 2048->32000 Q6_K; IQ4_XS 22 x [wqkv norm 2048->2560, wo, gate|up, "
                    "down] IQ4_XS + head Q6_K; Q2_K, IQ4_NL, MXFP4 the same with the head in "
                    "the type (launched padded to 32768); K5 the same weights at M = 256 (and "
                    "4); bounds by each weight's GGUF bytes, the layout's beside them "
                    "(layout_bytes_per_weight)",
          **lowbit_lines})
    lowbit_k4 = {f"{ft.lower()}_tinyllama": ln["k4"] for ft, ln in lowbit_lines.items()}
    lowbit_k5 = {f"{ft.lower()}_tinyllama": ln["k5"] for ft, ln in lowbit_lines.items()}
    lowbit_k5["q3_k_m_tinyllama_m4"] = lowbit_lines["Q3_K_M"]["k5_m4"]

    # the IQ grid forms by weight role: K4 on each IQ step's 110 matvecs
    # (IQ1_M: K5 at M = 1 in its place), K5 on the chunk's GEMMs (and at M
    # = 4 on the IQ3_XXS weights); K1 on each step's 23 wv (Q4_K) and head
    # (Q5_K) matvecs, for `step_graph`
    iq_lines = {ft: role_lines(iq_models[ft], k4_k5,
                               ("k5_m1" if ft == "IQ1_M" else "k4", "k5"), all_heads=False,
                               m4=ft == "IQ3_XXS", m1=ft == "IQ1_M") for ft in IQ_FTYPES}
    for ft, m_ in iq_models.items():
        k1_calls = [(x_h, layer["wv"], "q", None) for layer in m_.params["layers"]]
        k1_calls.append((x_res, m_.params["output"], "norm", m_.params["out_norm"]))
        iq_lines[ft]["k1_wv_head"] = dict(
            matvec_phase(torch, qmm.q4k_matvec, qmm.q4k_matvec_plain, k1_calls, n_real, None,
                         cfg.norm_eps, check=(0, len(k1_calls) - 1)),
            launches=len(k1_calls), fmt="Q4_K wv, Q5_K head", tolerance=1e-6)
    bad_iq = failed(iq_lines)
    emit({"phase": "kernel_iq", "card": card,
          "shapes": "TinyLlama geometry, each preset from the factory: 22 x [wq, wk q "
                    "2048->2048/256 (bf16 x), wo q 2048->2048, gate|up norm 2048->11264, down "
                    "glu 5632->2048] in the type (IQ1_M: K5 at M = 1 on the same weights, "
                    "bf16 / f32 rows as the step's); K5 the same weights at M = 256 (IQ3_XXS "
                    "also 4); k1_wv_head: 22 x wv q 2048->256 Q4_K + head norm 2048->32000 "
                    "Q5_K (launched padded to 32768); bounds by each weight's GGUF bytes, the "
                    "layout's beside them (layout_bytes_per_weight)",
          **iq_lines})
    iq_k4 = {f"{ft.lower()}_tinyllama": ln["k4"] for ft, ln in iq_lines.items() if "k4" in ln}
    iq_k5 = {f"{ft.lower()}_tinyllama": ln["k5"] for ft, ln in iq_lines.items()}
    iq_k5["iq3_xxs_tinyllama_m4"] = iq_lines["IQ3_XXS"]["k5_m4"]
    iq_k5["iq1_m_tinyllama_m1_step"] = iq_lines["IQ1_M"]["k5_m1"]

    # the ternary forms by weight role: K4 on each TQ step's 88 matvecs and
    # its Q6_K head ("head Q6_K"), K5 on the chunk's GEMMs (and at M = 4 on
    # the TQ2_0 weights); bounded by each weight's GGUF bytes (54 and 66 per
    # 256, the head's 210), the layout's 80 per 256 beside them
    tq_lines = {ft: role_lines(tq_models[ft], k4_k5, ("k4", "k5"), all_heads=True,
                               m4=ft == "TQ2_0") for ft in TQ_FTYPES}
    bad_tq = failed(tq_lines)
    emit({"phase": "kernel_tq", "card": card,
          "shapes": "TinyLlama geometry, each file by zllm_torch.quantize: 22 x [wqkv norm "
                    "2048->2560, wo q 2048->2048, gate|up norm 2048->11264, down glu "
                    "5632->2048] in the type + head norm 2048->32000 Q6_K (launched padded to "
                    "32768); K5 the same weights at M = 256 (TQ2_0 also 4); bounds by each "
                    "weight's GGUF bytes, the layout's beside them (layout_bytes_per_weight)",
          **tq_lines})
    tq_k4 = {f"{ft.lower()}_tinyllama": ln["k4"] for ft, ln in tq_lines.items()}
    tq_k5 = {f"{ft.lower()}_tinyllama": ln["k5"] for ft, ln in tq_lines.items()}
    tq_k5["tq2_0_tinyllama_m4"] = tq_lines["TQ2_0"]["k5_m4"]

    # the earlier kernel forms keep their bits: digests of their outputs on
    # seeded inputs, to be compared with another tree's (`--digest`)
    digests = form_digests(torch)
    emit({"phase": "form_digests", "tree": str(REPO), **digests})

    # K4: one Q4_K_M decode step's 34 Q6_K matvecs, in the model's dtypes:
    # wv takes the bf16 normed row, ffn_down the f32 gate|up row, the head
    # the bf16 residual
    x_resb = randn(1, d_model, dtype=torch.bfloat16, scale=3.0)
    calls4 = []
    for layer in layers_m:
        calls4.append((x_h, layer["wv"], "q", None))
        if layer["ffn_down"].fmt == GGMLType.Q6_K:
            calls4.append((x_gup, layer["ffn_down"], "glu", None))
    calls4.append((x_resb, head_m, "norm", model_m.params["out_norm"]))
    groups = {"wv": [i for i, c in enumerate(calls4) if c[2] == "q"],
              "ffn_down": [i for i, c in enumerate(calls4) if c[2] == "glu"],
              "head": [len(calls4) - 1]}
    # a digest of K4's outputs on these seeded inputs: equal digests on two
    # trees mean bit-equal outputs
    k4_digest = hashlib.sha256()
    for x, w, fuse, aux in calls4:
        k4_digest.update(qmm.int8_matvec(x, w, fuse, aux, cfg.norm_eps).cpu().numpy().tobytes())
    lines.append(dict(name="int8_matvec", route="cuda", source="zllm_torch/csrc/int8_matvec.cu",
                      output_digest=k4_digest.hexdigest()[:16],
                      replaces="zllm/ops/qmatmul.py:501", launches=counts_q4km["int8_matvec"],
                      **matvec_phase(torch, qmm.int8_matvec, qmm.int8_matvec_plain, calls4, n_real,
                                     GGUF_BYTES_PER_WEIGHT["Q6_K"], cfg.norm_eps,
                                     check=(0, groups["ffn_down"][0], len(calls4) - 1),
                                     groups=groups),
                      tolerance=1e-6, launches_by_path=by_path("int8_matvec"),
                      unit="one Q4_K_M decode step (34 launches)",
                      shapes="22 x wv q 2048->256 (bf16 x) + 11 x down glu 5632->2048 + head "
                             "norm 2048->32000 (launched padded to 32768), all Q6_K",
                      launches_per_step=len(calls4)))

    # K5: one Q4_K_M prefill chunk's 34 Q6_K GEMMs at M = 256 (wv and the
    # head take bf16 normed rows, ffn_down the f32 SwiGLU rows)
    gcalls5 = [(xh_m if w.shape[0] == d_model else xs[n_ff], w) for _, w, _, _ in calls4]
    lines.append(dict(name="dequant_gemm", route="cuda", source="zllm_torch/csrc/dequant_gemm.cu",
                      replaces="zllm/ops/qmatmul.py:1542", launches=counts_q4km["dequant_gemm"],
                      loop="zllm_torch/csrc/gemm_slice.cuh",
                      **gemm_phase(torch, qmm.dequant_gemm, qmm.dequant_gemm_plain, gcalls5,
                                   n_real, GGUF_BYTES_PER_WEIGHT["Q6_K"],
                                   check=(0, groups["ffn_down"][0], len(gcalls5) - 1),
                                   groups=groups),
                      tolerance=1e-6, launches_by_path=by_path("dequant_gemm"),
                      unit="one Q4_K_M prefill chunk (34 launches)",
                      shapes="M=256 x [22 x wv 2048->256 (bf16 x), 11 x down 5632->2048 (f32 x), "
                             "head 2048->32000 (launched padded to 32768)], all Q6_K",
                      launches_per_chunk=len(gcalls5)))

    # K3 and K5 at the engine's decode M = 4 (one row per slot): one serve
    # decode step's 99 Q4_K and 34 Q6_K GEMMs of the Q4_K_M model
    x4 = {d_model: randn(4, d_model), n_ff: randn(4, n_ff)}
    xh4 = randn(4, d_model, dtype=torch.bfloat16)

    def rows4(x):
        return xh4 if x.dtype == torch.bfloat16 else x4[x.shape[1]]

    g4_k3 = [(rows4(x), w) for x, w in gcalls_m]
    g4_k5 = [(rows4(x), w) for x, w in gcalls5]
    by_name = {ln["name"]: ln for ln in lines}  # now with K4 and K5
    by_name["int8_matvec"]["q5_k_m_tinyllama"] = q5_lines["Q5_K_M"]["k4"]
    by_name["int8_matvec"].update(lowbit_k4)
    by_name["dequant_gemm"].update(lowbit_k5)
    by_name["int8_matvec"].update(iq_k4)
    by_name["dequant_gemm"].update(iq_k5)
    by_name["int8_matvec"].update(tq_k4)
    by_name["dequant_gemm"].update(tq_k5)
    by_name["q4k_gemm"]["serve_decode_step_m4"] = dict(
        gemm_phase(torch, qmm.q4k_gemm, qmm.q4k_gemm_plain, g4_k3, n_real,
                   GGUF_BYTES_PER_WEIGHT["Q4_K"], check=(0, len(g4_k3) - 1), groups=roles_m),
        launches=len(g4_k3), shapes="M=4 x the 99 Q4_K weights of a Q4_K_M step")
    by_name["dequant_gemm"]["serve_decode_step_m4"] = dict(
        gemm_phase(torch, qmm.dequant_gemm, qmm.dequant_gemm_plain, g4_k5, n_real,
                   GGUF_BYTES_PER_WEIGHT["Q6_K"], check=(0, groups["ffn_down"][0], len(g4_k5) - 1),
                   groups=groups),
        launches=len(g4_k5), shapes="M=4 x the 34 Q6_K weights of a Q4_K_M step")
    bad_m4 = [n for n in ("q4k_gemm", "dequant_gemm")
              if not by_name[n]["serve_decode_step_m4"]["nmse"] <= 1e-6]

    # K3's and K5's rows do not depend on M: the engine's 4-row decode step
    # (row form) and its 512-row mixed step (tile form) give a generating
    # row the same bits, on every Q4_K (K3) and Q6_K (K5) weight of the
    # Q4_K_M model and every Q5_K weight of the Q5_K_M one, every Q3_K (K5)
    # weight of the Q3_K_M one and IQ4_XS weight of the IQ4_XS one, and on a
    # Q4_0 and a Q5_0 (gate|up) and a Q4_1 (OLMo-2) and a Q5_1 (ffn_down)
    # one, and a Q2_K, an IQ4_NL and an MXFP4 gate|up
    x512 = {k: randn(512, k) for k in (d_model, n_ff, cfg_o.n_ff)}
    xh512 = randn(512, d_model, dtype=torch.bfloat16)

    def rows_same(fn, pairs):
        same = []
        for x, w in pairs:
            xb = xh512 if x.dtype == torch.bfloat16 else x512[x.shape[1]]
            full = fn(xb, w)
            same.append(torch.equal(fn(xb[:4], w), full[:4])
                        and torch.equal(fn(xb[508:], w), full[508:]))
        return sum(same), len(same)

    w40 = model_40.params["layers"][0]["ffn_gateup"]
    w41 = model_o1.params["layers"][0]["ffn_down"]
    w50 = q5_models["Q5_0"].params["layers"][0]["ffn_gateup"]
    w51 = q5_models["Q5_1"].params["layers"][0]["ffn_down"]
    rows = {"dequant_gemm": {"Q4_K_M Q6_K": rows_same(qmm.dequant_gemm, gcalls5),
                             **{f"{ft} {fmt}": rows_same(qmm.dequant_gemm, [
                                 c for c in role_calls(lowbit_models[ft], True)[1]
                                 if c[1].fmt.name == fmt])
                                for ft, fmt in (("Q3_K_M", "Q3_K"), ("IQ4_XS", "IQ4_XS"))},
                             **{f"{ft} gate|up": rows_same(qmm.dequant_gemm, [
                                 (x512[d_model],
                                  lowbit_models[ft].params["layers"][0]["ffn_gateup"])])
                                for ft in ("Q2_K", "IQ4_NL", "MXFP4")},
                             **{f"{ft} {ft}": rows_same(qmm.dequant_gemm,
                                                        role_calls(iq_models[ft], False)[1])
                                for ft in ("IQ3_XXS", "IQ1_S", "IQ1_M")},
                             **{f"{ft} gate|up": rows_same(qmm.dequant_gemm, [
                                 (x512[d_model], iq_models[ft].params["layers"][0]["ffn_gateup"])])
                                for ft in IQ_FTYPES[3:]},
                             **{f"{ft} {ft}": rows_same(qmm.dequant_gemm,
                                                        role_calls(tq_models[ft], False)[1])
                                for ft in TQ_FTYPES}},
            "q4k_gemm": {"Q4_K_M Q4_K": rows_same(qmm.q4k_gemm, gcalls_m),
                         "Q4_0 gate|up": rows_same(qmm.q4k_gemm, [(x512[d_model], w40)]),
                         "Q4_1 OLMo-2 ffn_down": rows_same(qmm.q4k_gemm,
                                                           [(x512[cfg_o.n_ff], w41)]),
                         "Q5_K_M Q5_K": rows_same(qmm.q4k_gemm,
                                                  role_calls(q5_models["Q5_K_M"],
                                                             False)[1]),
                         "Q5_0 gate|up": rows_same(qmm.q4k_gemm, [(x512[d_model], w50)]),
                         "Q5_1 ffn_down": rows_same(qmm.q4k_gemm, [(x512[n_ff], w51)])}}
    bad_rows = []
    for name, sets in rows.items():
        by_name[name]["rows_m4_equal_m512"] = {
            label: dict(weights=n, bitwise_equal=ok) for label, (ok, n) in sets.items()}
        bad_rows += [f"{name} {label}: {n - ok} of {n}" for label, (ok, n) in sets.items()
                     if ok != n]
    if bad_rows:
        fail(f"rows at M = 4 differ from the same rows of an M = 512 call: {bad_rows}")

    # K4 and K5 once each on a full-width Q8_0 weight (gate shape 2048->5632)
    rng_w = torch.Generator().manual_seed(1)
    w8 = repack(qb.quantize((torch.randn(n_ff, d_model, generator=rng_w) * 0.05).numpy(),
                            GGMLType.Q8_0), (n_ff, d_model), GGMLType.Q8_0, "cuda")
    x8 = randn(m_rows, d_model)
    mv, mv_plain = (qmm.int8_matvec(x_resb, w8, "norm", layers_m[0]["attn_norm"], cfg.norm_eps),
                    qmm.int8_matvec_plain(x_resb, w8, "norm", layers_m[0]["attn_norm"],
                                          cfg.norm_eps))
    gm, gm_plain = qmm.dequant_gemm(x8, w8), qmm.dequant_gemm_plain(x8, w8)
    w8d, x8b = w8.dequant(torch.bfloat16), x8.to(torch.bfloat16)
    wbytes = d_model * n_ff * GGUF_BYTES_PER_WEIGHT["Q8_0"]
    mv_b = bound_ms(wbytes + 2 * d_model + 4 * d_model + 4 * n_ff, 2 * d_model * n_ff, "int8")
    gm_b = bound_ms(wbytes + 4 * m_rows * (d_model + n_ff), 2 * m_rows * d_model * n_ff, "bf16")
    q8 = {"phase": "kernel_q8_0", "card": card, "shape": f"K={d_model} N={n_ff} Q8_0",
          "int8_matvec": dict(fuse="norm", nmse=nmse(mv, mv_plain), tolerance=1e-6,
                              max_abs_err=float((mv - mv_plain).abs().max()),
                              ms=cuda_ms(lambda: qmm.int8_matvec(
                                  x_resb, w8, "norm", layers_m[0]["attn_norm"], cfg.norm_eps), 50),
                              library_ms=cuda_ms(lambda: torch.matmul(x_resb, w8d), 50),
                              bound_ms=mv_b[0], bound_by=mv_b[1]),
          "dequant_gemm": dict(m=m_rows, nmse=nmse(gm, gm_plain), tolerance=1e-6,
                               max_abs_err=float((gm - gm_plain).abs().max()),
                               ms=cuda_ms(lambda: qmm.dequant_gemm(x8, w8), 20),
                               library_ms=cuda_ms(lambda: torch.matmul(x8b, w8d), 20),
                               bound_ms=gm_b[0], bound_by=gm_b[1])}
    emit(q8)
    bad_q8 = [k for k in ("int8_matvec", "dequant_gemm") if not q8[k]["nmse"] <= 1e-6]

    # a decode step's device time in a CUDA graph beside the sum of its
    # kernels' graph times (the rest: the torch ops, and the gaps between)
    by_name = {ln["name"]: ln for ln in lines}
    for name in ("dequant_gemm", "flash_attention"):  # an imatrix forward's (kernel_imatrix)
        by_name[name]["imatrix_forward"] = k_imatrix[name]
    k1_q4k = by_name["q4k_matvec"]["ms"]
    emit({"phase": "step_graph", "card": card,
          "tinyllama_q4k": dict(step_graph_ms=step_q4k, k1_ms=k1_q4k,
                                k2_ms=by_name["attn_decode_qkv"]["ms"],
                                kernels_ms=k1_q4k + by_name["attn_decode_qkv"]["ms"]),
          "tinyllama_q4km": dict(step_graph_ms=step_m, k1_ms=q4km_k1["ms"],
                                 k4_ms=by_name["int8_matvec"]["ms"],
                                 k2_ms=by_name["attn_decode_qkv"]["ms"],
                                 kernels_ms=q4km_k1["ms"] + by_name["int8_matvec"]["ms"]
                                 + by_name["attn_decode_qkv"]["ms"]),
          "olmo2_q4k": dict(step_graph_ms=step_o, k1_ms=k1_o["ms"], k8_ms=k8_o["ms"],
                            kernels_ms=k1_o["ms"] + k8_o["ms"]),
          "olmo2_q4k_f16_kv": dict(
              step_graph_ms=step_o16, k1_ms=k1_o["ms"],
              k8_ms=line_f16["attn_decode_update"]["olmo2_step"]["ms"],
              kernels_ms=k1_o["ms"] + line_f16["attn_decode_update"]["olmo2_step"]["ms"]),
          **{f"tinyllama_{ft.lower()}": dict(step_graph_ms=tq_steps[ft],
                                             k4_ms=tq_lines[ft]["k4"]["ms"],
                                             k2_ms=by_name["attn_decode_qkv"]["ms"],
                                             kernels_ms=tq_lines[ft]["k4"]["ms"]
                                             + by_name["attn_decode_qkv"]["ms"])
             for ft in TQ_FTYPES},
          "tinyllama_bf16": dict(step_graph_ms=step_bf16,
                                 k2_ms=by_name["attn_decode_qkv"]["bf16_q"]["ms"],
                                 kernels_ms=by_name["attn_decode_qkv"]["bf16_q"]["ms"]),
          "tinyllama_q5km": dict(step_graph_ms=q5_steps["Q5_K_M"],
                                 k1_ms=q5_lines["Q5_K_M"]["k1"]["ms"],
                                 k4_ms=q5_lines["Q5_K_M"]["k4"]["ms"],
                                 k2_ms=by_name["attn_decode_qkv"]["ms"],
                                 kernels_ms=q5_lines["Q5_K_M"]["k1"]["ms"]
                                 + q5_lines["Q5_K_M"]["k4"]["ms"]
                                 + by_name["attn_decode_qkv"]["ms"]),
          **{f"tinyllama_{ft.lower()}": dict(step_graph_ms=q5_steps[ft],
                                             k1_ms=q5_lines[ft]["k1"]["ms"],
                                             k2_ms=by_name["attn_decode_qkv"]["ms"],
                                             kernels_ms=q5_lines[ft]["k1"]["ms"]
                                             + by_name["attn_decode_qkv"]["ms"])
             for ft in ("Q5_0", "Q5_1")},
          "tinyllama_q3km": dict(step_graph_ms=lowbit_steps["Q3_K_M"],
                                 k4_ms=lowbit_lines["Q3_K_M"]["k4"]["ms"],
                                 k1_ms=lowbit_lines["Q3_K_M"]["k1_wv"]["ms"],
                                 k2_ms=by_name["attn_decode_qkv"]["ms"],
                                 kernels_ms=lowbit_lines["Q3_K_M"]["k4"]["ms"]
                                 + lowbit_lines["Q3_K_M"]["k1_wv"]["ms"]
                                 + by_name["attn_decode_qkv"]["ms"]),
          **{f"tinyllama_{ft.lower()}": dict(step_graph_ms=lowbit_steps[ft],
                                             k4_ms=lowbit_lines[ft]["k4"]["ms"],
                                             k2_ms=by_name["attn_decode_qkv"]["ms"],
                                             kernels_ms=lowbit_lines[ft]["k4"]["ms"]
                                             + by_name["attn_decode_qkv"]["ms"])
             for ft in LOWBIT_FTYPES if ft != "Q3_K_M"},
          **{f"tinyllama_{ft.lower()}": dict(
              step_graph_ms=iq_steps[ft], k1_ms=iq_lines[ft]["k1_wv_head"]["ms"],
              k2_ms=by_name["attn_decode_qkv"]["ms"],
              **({"k5_m1_ms": iq_lines[ft]["k5_m1"]["ms"]} if ft == "IQ1_M"
                 else {"k4_ms": iq_lines[ft]["k4"]["ms"]}),
              kernels_ms=iq_lines[ft]["k5_m1" if ft == "IQ1_M" else "k4"]["ms"]
              + iq_lines[ft]["k1_wv_head"]["ms"] + by_name["attn_decode_qkv"]["ms"])
             for ft in IQ_FTYPES},
          **{label: dict(step_graph_ms=st["step_graph_ms"], k1_ms=st["k1"]["ms"],
                         k4_ms=st["k4"]["ms"] if "k4" in st else 0.0, k2_ms=st["k2"]["ms"],
                         head_ms=st["head"]["ms"],
                         kernels_ms=st["k1"]["ms"] + (st["k4"]["ms"] if "k4" in st else 0.0)
                         + st["k2"]["ms"] + st["head"]["ms"])
             for label, st in (("qwen3_q4k", qwen3_step), ("qwen25_q4km", qwen25_step))},
          "note": "one B = 1 decode step's forward at the last decode position, captured once "
                  "and replayed; kernels_ms sums the step's K1 and K2 (Q4_K_M, Q5_K_M: K1, K4 "
                  "and K2; OLMo-2: K1 and K8; Qwen: K1, K4, K2 and the tied head's matmul; "
                  "Q3_K_M: K4, K1 and K2; IQ4_XS, Q2_K, IQ4_NL, MXFP4, TQ2_0, TQ1_0: K4 and "
                  "K2; the IQ grid presets: K4 (IQ1_M: K5 at M = 1), K1 for wv and the head, "
                  "and K2; BF16: K2 alone, its matmuls torch's; OLMo-2 over an f16 cache: K1 "
                  "and K8's f16 form) graph times from the kernel phases"})

    lines += gemma["lines"]  # the d 256 forms (group 9), each a line of its own
    lines += moe["lines"]  # the experts' K3 / K5 and K7's d 256 forms (group 10)
    lines += layernorm["lines"]  # partial neox K2, G 12 K2 / K9 / K10, a Pythia K6 (group 11)
    lines += gpt_oss["lines"]  # K2's, K6's and K7's sinks forms (group 12)
    for line in lines:
        emit({"phase": "kernel", "card": card, **line})
    bad = [ln["name"] for ln in lines if not ln["nmse"] <= ln["tolerance"]]
    if not by_name["attn_decode_qkv"]["tinyllama_engine_step"]["nmse"] <= 1e-5:
        bad.append("attn_decode_qkv tinyllama_engine_step")
    if (bad or bad_q8 or bad_m4 or bad_k6 or bad_k7 or bad_k8 or bad_legacy or bad_q5
            or bad_lowbit or bad_iq or bad_tq):
        fail(f"kernels disagree with their plain versions: {bad} (Q8_0: {bad_q8}, "
             f"M=4: {bad_m4}, K6: {bad_k6}, K7: {bad_k7}, K8: {bad_k8}, Q4_0/Q4_1: "
             f"{bad_legacy}, Q5: {bad_q5}, low-bit: {bad_lowbit}, IQ: {bad_iq}, TQ: {bad_tq})")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # the weight formats each matmul kernel takes (its forms)
    forms = {name: [f.name for f in fmts] for name, fmts in (
        ("q4k_matvec", qmm.NIBBLE_FMT_CODE), ("q4k_gemm", qmm.NIBBLE_FMT_CODE),
        ("int8_matvec", qmm.K4_FMTS), ("dequant_gemm", qmm.INT8_FMT_CODE),
        ("q4k_matvec_hbm", qmm.HBM_FMTS), ("w4a8dd_matvec", qmm.DUALDOT_FMTS))}
    # the attention kernels' forms: the K/V (cache or pool) dtypes each takes
    forms.update({name: ["float32", "bfloat16", "float16"] for name in (
        "attn_decode_qkv", "flash_attention", "paged_attn_decode_update", "paged_attention")})
    forms.update(attn_decode_update=["float32", "bfloat16", "float16"],
                 flash_attention_blockwise=["bfloat16", "int8"],
                 flash_attention_blockwise_d256=["bfloat16", "int8"],
                 **{name: ["float32", "bfloat16", "float16"] for name in (
                     "attn_decode_qkv_neox_r32", "attn_decode_qkv_neox_r16_d64",
                     "attn_decode_qkv_g12", "flash_attention_pythia",
                     "paged_attn_decode_update_g12", "paged_attention_g12")},
                 flash_attention_blockwise_g12=["bfloat16", "int8"],
                 attn_decode_qkv_sinks=["float32", "bfloat16", "float16"],
                 flash_attention_sinks=["float32", "bfloat16", "float16"],
                 flash_attention_blockwise_sinks=["bfloat16", "int8"],
                 **{f"{name}_pythia": forms[name] for name in (
                     "q4k_matvec", "int8_matvec", "q4k_gemm", "dequant_gemm")},
                 q4k_gemm_experts=forms["q4k_gemm"], dequant_gemm_experts=forms["dequant_gemm"])
    emit({"kernels": [dict({k: ln[k] for k in keys},
                           **({"forms": forms[ln["name"]]} if ln["name"] in forms else {}))
                      for ln in lines]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--make-gguf"]:  # a child of prepare_requantized
        os.nice(10)  # the kernels' nvccs and the card's phases first
        sys.path.insert(0, str(REPO))
        for ftype_ in sys.argv[3:]:
            gguf_file(sys.argv[2], main_shapes()[sys.argv[2]][0], ftype_)
    elif sys.argv[1:2] == ["--api"]:  # group 7 alone
        api_phases()
    elif sys.argv[1:2] == ["--spec"]:  # group 8 alone
        spec_phases()
    elif sys.argv[1:2] == ["--gemma"]:  # group 9 alone
        gemma_phases()
    elif sys.argv[1:2] == ["--gemma-cpu"]:  # a child of start_gemma_cpu_checks
        os.nice(10)
        sys.path.insert(0, str(REPO))
        gemma_cpu_reference(sys.argv[2])
    elif sys.argv[1:2] == ["--moe"]:  # group 10 alone
        moe_phases()
    elif sys.argv[1:2] == ["--moe-cpu"]:  # a child of start_moe_children
        os.nice(19)
        sys.path.insert(0, str(REPO))
        moe_cpu_reference(sys.argv[2])
    elif sys.argv[1:2] == ["--layernorm"]:  # group 11 alone
        layernorm_phases()
    elif sys.argv[1:2] == ["--gpt-oss"]:  # group 12 alone
        gpt_oss_phases()
    elif sys.argv[1:2] == ["--ln-cpu"]:  # a child of start_ln_children
        os.nice(19)
        sys.path.insert(0, str(REPO))
        import torch

        torch.set_num_threads(2)
        gemma_cpu_reference(sys.argv[2])
    elif sys.argv[1:2] == ["--serve-q8"]:  # serve_q8 and the q8 insert alone
        serve_q8_ab(int(sys.argv[2]) if len(sys.argv) > 2 else 3)
    elif sys.argv[1:2] == ["--digest"]:  # the earlier kernel forms' digests alone
        if not (REPO / "zllm_torch" / "csrc").is_dir():
            fail("zllm_torch/ is not beside chip_smoke.py: run from the root of a checkout")
        sys.path.insert(0, str(REPO))
        import torch

        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is False: the digests need a CUDA GPU")
        from zllm_torch.ops import cuda as cuda_build

        cuda_build.build()  # every kernel at once, not one at a time at first use
        emit({"phase": "form_digests", "tree": str(REPO), **form_digests(torch)})
    else:
        main()
