"""The serving path: continuous-batching engine over the paged KV cache and
its OpenAI-compatible HTTP front end (`python -m zllm_torch.server`)."""

from .engine import Engine, Request
from .http import ZllmServer
