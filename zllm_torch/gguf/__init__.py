from .constants import GGMLType, GGUFValueType, GGML_BLOCK_SIZES, QK_K, K
from .reader import GGUFFile, TensorMeta, read_gguf
from .writer import GGUFWriter
