"""zllm_torch: the PyTorch/CUDA port of zllm for NVIDIA Hopper (H100).

A second package beside the JAX reference `zllm/`, imported by none of it
and importing none of it.  The first slice runs the Q4_K llama path:
GGUF -> QWeight -> llama forward -> chunked prefill + decode, through four
hand-written CUDA kernels (zllm_torch/csrc/).  Entry points run on the GPU
unless the caller asks for device="cpu", where each kernel's plain
PyTorch version runs instead.
"""
