"""zllm_torch: the PyTorch/CUDA port of zllm for NVIDIA Hopper (H100).

A second package beside the JAX reference `zllm/`, imported by none of it
and importing none of it.  It runs the llama path for Q4_K, Q4_K_M and
Q8_0 files: GGUF -> QWeight -> llama forward -> chunked prefill + decode,
through six hand-written CUDA kernels (zllm_torch/csrc/).  Entry points run on the GPU
unless the caller asks for device="cpu", where each kernel's plain
PyTorch version runs instead.
"""
